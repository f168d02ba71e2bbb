// The frame's shading for Hopper (sm_90a), two kernels a radiance level:
// vrt_shade_surface before the traces the level spawns and vrt_shade_combine
// after them.
//
// They replace no Pallas kernel: vrt leaves shading to XLA, which fuses
// vrt/render/renderer.py::_per_ray_instance, _voxel_color_sample, _shade_lit,
// _shade_unlit_mode, the selects of trace_radiance and tonemap with
// vrt/shade/brdf.py, lights.py and texture.py into a few loops.  Eager PyTorch
// runs the same lines one launch an operation, about a thousand launches a
// level over [R] and [R,3] tensors, with per-ray gathers from tables of two
// rows.  The kernels compute what
// vrt_torch.render.renderer.shade_surface_reference and
// shade_combine_reference (their plain versions) compute.
//
// ---- surface ----------------------------------------------------------------
//
// From the march's hit / instance (and hit cell, with per-voxel colours) and
// the resolve's t / object-space normal: the hit point and the shadow origin,
// the material there (triplanar albedo, roughness / metallic and tangent-normal
// samples: 36 taps, or the trilinear colour sample of one 24-channel row, or
// of 8 voxel rows of 3 where vrt leaves the colours unpacked), the
// world normal, with a bounce the mirror direction and its gate, and the
// shadow rays of the level: per light a t_max (-inf where nobody reads the
// shadow), per point and spot light a direction.  Every reader discards a miss
// lane: it reads the hit flag and the ray alone and writes only what the
// level's traces take, a closed gate, t_max = -inf and, as the rays the seam
// still marches, its own origin and direction (a ray without direction never
// leaves a box it starts in, whatever its t_max).  Its material (albedo,
// normal, roughness, metallic, k) is left unwritten: the combine kernel reads
// the record on hit lanes only.
//
// ---- combine ----------------------------------------------------------------
//
// From the surface record, the bounce's radiance and the shadow traces'
// booleans: the mirror term, the directional, point and spot lights
// (Cook-Torrance GGX; distance and intensity recomputed from the record), the
// unlit-attribute select, the env cube lookup on miss lanes and, for the
// primary rays, Reinhard + gamma into an [R,4] frame with alpha 1.
//
// What bounds them: bytes.  In a lit textured level without point or spot
// lights the surface kernel reads 45 B and writes 65 B on a hit lane, reads
// 25 B and writes 29 B on a miss lane (1 B and nothing at a level that spawns
// no trace); the combine kernel reads 14 B a ray and about 85 B more on a hit
// lane and writes 12 or 16 B.  The 2,073,600 primary rays of the flagship
// frame, one in sixteen a hit, move about 0.12 GB and 0.07 GB, 0.04 and 0.02
// ms at 3.35 TB/s, against some 1,500 f32 operations a hit ray (0.003 ms at
// 67 TFLOP/s).  The tables
// (instances, materials, lights, texture sizes) are a few hundred bytes.
//
// What the design does about it: every intermediate stays in registers; the
// tables are staged in shared memory, so no ray gathers from device memory
// but for its texture taps, its colour row and its env taps; the texture and
// colour work is compiled out by template flag where the mode has none.  Each
// kernel has two designs.  The first (surface_kernel, combine_kernel), kept
// as the comparator: one thread a ray over 8,100 blocks at 1080p, every block
// staging the tables and synchronising before its lanes read a flag, every
// access a lane's own 4-byte word.  What held it back on the H100
// (chip_smoke.py; ncu cannot run there): about half the bytes' bound, and at
// a level without traces 0.02 ms for 2 M one-byte flags, the blocks' staging
// alone.  The redesign (surface_resident_kernel, combine_resident_kernel,
// the default; below): resident blocks striding over the rays, a warp's
// flags and [32,3] spans in 16-byte words (the surface's fetched a round
// ahead by cp.async), and a surface warp without a hit writing only its
// traces' rays in 16-byte stores.  The surface gains; the combine, bound by
// its instructions (the env lookup on miss lanes, the tonemap's powf), runs
// at its first design's speed.  On the unpacked colour grid the surface
// has a design of its own (surface_voxels_kernel, below the redesign: one
// thread a ray, a lane's inputs loaded at once, its 24 colour loads
// together), the fastest of the three there at every size measured.  Built
// with --fmad=false and every sum
// written in the plain version's order; torch's own reductions (sum and
// vector_norm over 3, 4 and 8 elements) and pow may round in another
// order, so a result agrees with the plain version to a few ulp, not bit
// for bit, and a comparison that feeds a select (a texel's floor, the cube
// face, the gate, a light's floor) may flip on a lane in a million.

#include <algorithm>
#include <map>
#include <mutex>
#include <set>
#include <tuple>

#include <cuda_pipeline.h>

#include "scene.cuh"

namespace {

using namespace vrt;

constexpr int kThreads = 256;
constexpr int kMaxLights = 5;         // MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS
constexpr int kMaxBlocked = 1 + 2 * kMaxLights;
constexpr float kPi = 3.141592f;      // shade/brdf.py PI, deliberately short
constexpr float kF0Diel = 0.04f;
constexpr float kShadowBrightness = 0.0f;
constexpr float kDirShadowTmax = 5000.0f;

// rows of the staged tables, in 4-byte words
constexpr int kInstRow = 12;   // pos 3, rot 4, scale 3, volume
constexpr int kVolRow = 16;    // n, cell_size, extends, tint 3, roughness,
                               // metallic, k, tex_scale 2, albedo / normal /
                               // rm texture ids
constexpr int kPointRow = 12;  // pos 3, intensity, att_l, att_e, colour 3
constexpr int kSpotRow = 16;   // pos 3, fwd 3, intensity, att_l, att_e,
                               // cos_angle, cos_falloff, colour 3

struct Materials {
  const int32_t* n;         // [V] voxels per axis
  const float* cell_size;   // [V]
  const float* extends;     // [V]
  const float* tint;        // [V,4]
  const float* roughness;   // [V]
  const float* metallic;    // [V]
  const float* k;           // [V]
  const float* tex_scale;   // [V,2]
  const int32_t* albedo_tex;
  const int32_t* normal_tex;
  const int32_t* rm_tex;
  int count;
};

struct Lights {
  const float* dir;             // [3]
  const float* dir_strength;    // []
  const float* point_pos;       // [5,3]
  const float* point_intensity; // [5]
  const float* point_att_l;
  const float* point_att_e;
  const float* point_color;     // [5,4]
  const float* spot_pos;        // [5,3]
  const float* spot_fwd;        // [5,3]
  const float* spot_intensity;
  const float* spot_att_l;
  const float* spot_att_e;
  const float* spot_cos_angle;
  const float* spot_cos_falloff;
  const float* spot_color;      // [5,4]
  int points;
  int spots;
};

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// torch.clamp / clamp_min / clamp_max: NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return nmin(nmax(x, 0.0f), 1.0f);
}

// The lights into shared memory: 4 words of the directional light, then the
// point rows, then the spot rows.
__device__ __forceinline__ void stage_lights(float* sh, const Lights& l) {
  const int words = 4 + l.points * kPointRow + l.spots * kSpotRow;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    float v = 0.0f;
    if (w < 3) {
      v = l.dir[w];
    } else if (w == 3) {
      v = l.dir_strength[0];
    } else if (w < 4 + l.points * kPointRow) {
      const int i = (w - 4) / kPointRow, c = (w - 4) % kPointRow;
      if (c < 3) v = l.point_pos[3 * i + c];
      else if (c == 3) v = l.point_intensity[i];
      else if (c == 4) v = l.point_att_l[i];
      else if (c == 5) v = l.point_att_e[i];
      else if (c < 9) v = l.point_color[4 * i + (c - 6)];
    } else {
      const int r = w - 4 - l.points * kPointRow;
      const int i = r / kSpotRow, c = r % kSpotRow;
      if (c < 3) v = l.spot_pos[3 * i + c];
      else if (c < 6) v = l.spot_fwd[3 * i + (c - 3)];
      else if (c == 6) v = l.spot_intensity[i];
      else if (c == 7) v = l.spot_att_l[i];
      else if (c == 8) v = l.spot_att_e[i];
      else if (c == 9) v = l.spot_cos_angle[i];
      else if (c == 10) v = l.spot_cos_falloff[i];
      else if (c < 14) v = l.spot_color[4 * i + (c - 11)];
    }
    sh[w] = v;
  }
}

// shade/lights.py point_light_intensity.
__device__ __forceinline__ float attenuate(float intensity, float dist,
                                           float att_l, float att_e) {
  return intensity / ((1.0f + att_l * dist) + (att_e * dist) * dist);
}

// renderer.py _point_light / _spot_light from a staged row: the direction to
// the light (zero where the distance is), the distance and the intensity.
__device__ __forceinline__ void light_at(const float* row, bool spot,
                                         const float so[3], float sdir[3],
                                         float& dist, float& inten) {
  float delta[3];
  for (int c = 0; c < 3; ++c) delta[c] = row[c] - so[c];
  dist = sqrtf(dot3(delta, delta));
  for (int c = 0; c < 3; ++c)
    sdir[c] = dist != 0.0f ? delta[c] / dist : 0.0f;
  if (!spot) {
    inten = attenuate(row[3], dist, row[4], row[5]);
    return;
  }
  // shade/lights.py spot_light_intensity
  float to[3];
  for (int c = 0; c < 3; ++c) to[c] = so[c] - row[c];
  const float norm = sqrtf(dot3(to, to));
  for (int c = 0; c < 3; ++c) to[c] = to[c] / norm;
  const float cs = dot3(row + 3, to);
  const float cos_angle = row[9], cos_falloff = row[10];
  const bool inside = cs >= 0.0f && cs > cos_angle;
  const float cone = nmin((cs - cos_angle) / (cos_falloff - cos_angle), 1.0f);
  const float i = attenuate(row[6] * cone, dist, row[7], row[8]);
  inten = inside ? i : 0.0f;
}

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ void load3(const float* src, long long i,
                                      float v[3]) {
  for (int c = 0; c < 3; ++c) v[c] = src != nullptr ? src[3 * i + c] : 0.0f;
}

__device__ __forceinline__ void store3(float* dst, long long i,
                                       const float v[3]) {
  if (dst != nullptr)
    for (int c = 0; c < 3; ++c) dst[3 * i + c] = v[c];
}

__device__ __forceinline__ void store1(float* dst, long long i, float v) {
  if (dst != nullptr) dst[i] = v;
}

// ---- surface ----------------------------------------------------------------

struct SurfaceParams {
  const float* o_w;        // [R,3]
  const float* d_w;        // [R,3]
  const float* t;          // [R]
  const float* n_obj;      // [R,3]
  const uint8_t* hit;      // [R] bool
  const int32_t* cell;     // [R,3], read with per-voxel colours
  const int32_t* winner;   // [R] instance, -1 for none
  Instances inst;
  Materials mat;
  const float* textures;   // [T,TH,TW,3]
  const int32_t* tex_sizes;  // [T,2] (h, w)
  int tex_count, tex_h, tex_w;
  // the colour table in one of two layouts: packed, [V,cn,cn,cn,8,3] f32 or
  // bf16 (one 24-channel row a cell), or unpacked, the f32 voxel grid
  // [V,cn,cn,cn,3] with cn the corner table's voxels a side (vrt's layout
  // above its COLOR_CORNER_BUDGET_BYTES: 8 voxel rows of 3 a cell)
  const void* colors;
  int color_side;          // cn
  int colors_bf16;         // packed bf16
  int colors_unpacked;     // the voxel grid
  Lights lights;
  int bounce, shadows;
  long long rays;
  float* albedo;           // [R,3]
  float* shadow_origin;    // [R,3]
  float* n_w;              // [R,3]
  float* roughness;        // [R]
  float* metallic;         // [R]
  float* k;                // [R]
  float* refl_dir;         // [R,3] with bounce
  uint8_t* gate;           // [R] with bounce
  float* shadow_tmax;      // [1+P+S,R] with shadows
  float* shadow_dir;       // [P+S,R,3] with shadows
};

// The instance, volume and texture-size tables of the surface kernels into
// shared memory (rows of kInstRow and kVolRow words); the
// caller synchronises.
__device__ __forceinline__ void stage_surface_tables(const SurfaceParams& p,
                                                     float* sh_inst,
                                                     float* sh_vol,
                                                     int* sh_sizes) {
  for (int w = threadIdx.x; w < p.inst.count * kInstRow; w += blockDim.x) {
    const int r = w / kInstRow, c = w % kInstRow;
    float v = 0.0f;
    if (c < 3) v = p.inst.pos[3 * r + c];
    else if (c < 7) v = p.inst.rot[4 * r + (c - 3)];
    else if (c < 10) v = p.inst.scale[3 * r + (c - 7)];
    else if (c == 10) v = __int_as_float(p.inst.volume[r]);
    sh_inst[w] = v;
  }
  for (int w = threadIdx.x; w < p.mat.count * kVolRow; w += blockDim.x) {
    const int r = w / kVolRow, c = w % kVolRow;
    float v = 0.0f;
    if (c == 0) v = __int_as_float(p.mat.n[r]);
    else if (c == 1) v = p.mat.cell_size[r];
    else if (c == 2) v = p.mat.extends[r];
    else if (c < 6) v = p.mat.tint[4 * r + (c - 3)];
    else if (c == 6) v = p.mat.roughness[r];
    else if (c == 7) v = p.mat.metallic[r];
    else if (c == 8) v = p.mat.k[r];
    else if (c < 11) v = p.mat.tex_scale[2 * r + (c - 9)];
    else if (c == 11) v = __int_as_float(p.mat.albedo_tex[r]);
    else if (c == 12) v = __int_as_float(p.mat.normal_tex[r]);
    else if (c == 13) v = __int_as_float(p.mat.rm_tex[r]);
    sh_vol[w] = v;
  }
  for (int w = threadIdx.x; w < 2 * p.tex_count; w += blockDim.x)
    sh_sizes[w] = p.tex_sizes[w];
}

// torch.remainder on int32: the result takes the divisor's sign.
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int m = a % b;
  return (m != 0 && ((m < 0) != (b < 0))) ? m + b : m;
}

// shade/texture.py sample_bilinear_wrap for one texture.
__device__ __forceinline__ void sample_wrap(const SurfaceParams& p,
                                            const int* sizes, int id, float u_,
                                            float v_, float out[3]) {
  const int hi = sizes[2 * id], wi = sizes[2 * id + 1];
  const float h = static_cast<float>(hi), w = static_cast<float>(wi);
  const float u = u_ * w - 0.5f;
  const float v = v_ * h - 0.5f;
  const float u0 = floorf(u), v0 = floorf(v);
  const float fu = u - u0, fv = v - v0;
  const int ua = floor_mod(static_cast<int>(u0), wi);
  const int ub = floor_mod(static_cast<int>(u0 + 1.0f), wi);
  const int va = floor_mod(static_cast<int>(v0), hi);
  const int vb = floor_mod(static_cast<int>(v0 + 1.0f), hi);
  const float* base = p.textures +
                      static_cast<long long>(id) * p.tex_h * p.tex_w * 3;
  const float* c00 = base + (va * p.tex_w + ua) * 3;
  const float* c10 = base + (va * p.tex_w + ub) * 3;
  const float* c01 = base + (vb * p.tex_w + ua) * 3;
  const float* c11 = base + (vb * p.tex_w + ub) * 3;
  const float gu = 1.0f - fu, gv = 1.0f - fv;
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(c00 + c) * gu + __ldg(c10 + c) * fu;
    const float bot = __ldg(c01 + c) * gu + __ldg(c11 + c) * fu;
    out[c] = top * gv + bot * fv;
  }
}

// shade/texture.py tri_sample: uvX = zy / scale, uvY = xz / scale, uvZ = xy /
// scale, blended by |normal| / sum|normal|.  With kNormal the three samples
// are first mapped to [-1, 1] (tri_sample_normal's head).
template <bool kNormal>
__device__ __forceinline__ void tri_sample(const SurfaceParams& p,
                                           const int* sizes, int id,
                                           const float scale[2],
                                           const float pos[3],
                                           const float b[3], float out[3]) {
  float tx[3], ty[3], tz[3];
  sample_wrap(p, sizes, id, pos[2] / scale[0], pos[1] / scale[1], tx);
  sample_wrap(p, sizes, id, pos[0] / scale[0], pos[2] / scale[1], ty);
  sample_wrap(p, sizes, id, pos[0] / scale[0], pos[1] / scale[1], tz);
  for (int c = 0; c < 3; ++c) {
    if (kNormal) {
      tx[c] = tx[c] * 2.0f - 1.0f;
      ty[c] = ty[c] * 2.0f - 1.0f;
      tz[c] = tz[c] * 2.0f - 1.0f;
    }
    out[c] = (tx[c] * b[0] + ty[c] * b[1]) + tz[c] * b[2];
  }
}

// shade/texture.py _quat_from_x + core/quat.py from_two_vectors((1,0,0), v)
// and rotate: the tangent normal t (already swizzled .zxy) into the frame
// whose +X is the surface normal v.
__device__ __forceinline__ void rotate_from_x(const float v[3],
                                              const float t[3],
                                              float out[3]) {
  const float x[3] = {1.0f, 0.0f, 0.0f};
  float q[4];
  cross3(x, v, q);
  q[3] = 1.0f + ((x[0] * v[0] + x[1] * v[1]) + x[2] * v[2]);
  if (q[3] < 1e-6f) {
    // the half-turn about normalize(cross(x, RIGHT)) = +Z
    q[0] = 0.0f;
    q[1] = 0.0f;
    q[2] = 1.0f;
    q[3] = 0.0f;
  }
  const float norm = nmax(
      sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]),
      1e-12f);
  for (int c = 0; c < 4; ++c) q[c] = q[c] / norm;
  rotate(q, q[3], t, out);
}

// The packed colour row of a hit cell (its index clipped to the table).
__device__ __forceinline__ long long color_row(const SurfaceParams& p, int vol,
                                               const int cell[3]) {
  const long long cn = p.color_side;
  const int last = p.color_side - 1;
  return ((static_cast<long long>(vol) * cn + min(max(cell[0], 0), last)) *
              cn + min(max(cell[1], 0), last)) * cn +
         min(max(cell[2], 0), last);
}

// Channel c of corner j (CORNERS order) of a hit cell whose corners are all
// inside the table (the caller's valid mask): from the cell's packed row, or
// from the voxel grid's row of that corner.
__device__ __forceinline__ float corner_color(const SurfaceParams& p,
                                              long long row, int vol,
                                              const int cell[3], int j,
                                              int c) {
  if (p.colors_unpacked) {
    const long long nn = p.color_side;
    const long long vox =
        ((static_cast<long long>(vol) * nn + cell[0] + (j & 1)) * nn +
         cell[1] + ((j >> 1) & 1)) * nn + cell[2] + ((j >> 2) & 1);
    return load_corner<float>(static_cast<const float*>(p.colors) + 3 * vox +
                              c);
  }
  return p.colors_bf16
             ? load_corner<uint16_t>(static_cast<const uint16_t*>(p.colors) +
                                     row * 24 + 3 * j + c)
             : load_corner<float>(static_cast<const float*>(p.colors) +
                                  row * 24 + 3 * j + c);
}

// renderer.py _voxel_color_sample: the trilinear sample of one 24-channel
// colour row, or of 8 voxel rows of the unpacked grid, corners outside the
// volume reading zero.
__device__ __forceinline__ void color_sample(const SurfaceParams& p,
                                             long long i, int vol, int n,
                                             float h, float ext,
                                             const float o[3],
                                             const float d[3], float t,
                                             float out[3]) {
  int cell[3];
  float q[3];
  for (int c = 0; c < 3; ++c) {
    cell[c] = p.cell[3 * i + c];
    const float base = static_cast<float>(cell[c]) * h - ext;
    q[c] = ((o[c] + d[c] * t) - base) / h;
  }
  const long long row = color_row(p, vol, cell);
  out[0] = out[1] = out[2] = 0.0f;
  for (int j = 0; j < 8; ++j) {
    const int b[3] = {j & 1, (j >> 1) & 1, (j >> 2) & 1};
    bool valid = true;
    float w[3];
    for (int c = 0; c < 3; ++c) {
      const int idx = cell[c] + b[c];
      valid = valid && idx >= 0 && idx < n;
      w[c] = fabsf((b[c] ? 0.0f : 1.0f) - q[c]);
    }
    const float wj = (w[0] * w[1]) * w[2];
    for (int c = 0; c < 3; ++c) {
      const float v = valid ? corner_color(p, row, vol, cell, j, c) : 0.0f;
      const float term = wj * v;
      out[c] = j == 0 ? term : out[c] + term;
    }
  }
}

// The 8 corners' colours of a hit cell of volume `vol` (n voxels a side)
// from the unpacked grid, v[j] for corner j in CORNERS order (bit 0 x, bit 1
// y, bit 2 z), zero where the corner lies outside the volume (color_sample's
// valid mask): the 24 loads, all issued here.
__device__ __forceinline__ void voxel_corners(const SurfaceParams& p, int vol,
                                              int n, const int cell[3],
                                              float v[8][3]) {
  const long long nn = p.color_side;
  const float* grid = static_cast<const float*>(p.colors);
  for (int j = 0; j < 8; ++j) {
    const int x = cell[0] + (j & 1), y = cell[1] + ((j >> 1) & 1),
              z = cell[2] + ((j >> 2) & 1);
    const bool valid =
        x >= 0 && x < n && y >= 0 && y < n && z >= 0 && z < n;
    const long long vox =
        ((static_cast<long long>(vol) * nn + x) * nn + y) * nn + z;
    for (int c = 0; c < 3; ++c)
      v[j][c] = valid ? __ldg(grid + 3 * vox + c) : 0.0f;
  }
}

// color_sample's trilinear sum over corners loaded ahead (voxel_corners), in
// its order: the same weights, the same sum in j order.
__device__ __forceinline__ void voxel_trilinear(const int cell[3], float h,
                                                float ext, const float o[3],
                                                const float d[3], float t,
                                                float v[8][3],
                                                float out[3]) {
  float q[3];
  for (int c = 0; c < 3; ++c) {
    const float base = static_cast<float>(cell[c]) * h - ext;
    q[c] = ((o[c] + d[c] * t) - base) / h;
  }
  out[0] = out[1] = out[2] = 0.0f;
  for (int j = 0; j < 8; ++j) {
    const int b[3] = {j & 1, (j >> 1) & 1, (j >> 2) & 1};
    float w[3];
    for (int c = 0; c < 3; ++c) w[c] = fabsf((b[c] ? 0.0f : 1.0f) - q[c]);
    const float wj = (w[0] * w[1]) * w[2];
    for (int c = 0; c < 3; ++c) {
      const float term = wj * v[j][c];
      out[c] = j == 0 ? term : out[c] + term;
    }
  }
}

// A probe's comparison, never changed here: false compiles the colour
// sample out of the surface kernels (the albedo stays the material's tint),
// the chain of a hit lane without its colour gather
// (vrt_torch.apps.probe_caps).
constexpr bool kFwdColorSample = true;

// What a hit lane of the surface stage computes before its stores
// (renderer.py _shade_lit's head, _shade_unlit_mode): the material at the
// hit and, lit, the shadow origin, the world normal and the geometry term's
// k.  Both designs of the surface kernel share it.
struct SurfaceHit {
  float albedo[3], so[3], n_w[3];
  float roughness, metallic, k;
};

// The hit lane's values from its t and instance (winner) and, with per-voxel
// colours, `sample(vol, mat, o, d, t, albedo)`, the colour sample at the hit
// from the object-space ray.
template <bool kLit, bool kTextured, bool kColors, typename Sample>
__device__ __forceinline__ void surface_hit_from(
    const SurfaceParams& p, const float* sh_inst, const float* sh_vol,
    const int* sh_sizes, float t, int winner, const float o_w[3],
    const float d_w[3], const float n_obj[3], Sample sample, SurfaceHit& h) {
  const float* in = sh_inst + max(winner, 0) * kInstRow;
  const float* pos = in;
  const float* rot = in + 3;
  const float* scale = in + 7;
  const int vol = __float_as_int(in[10]);
  const float* mat = sh_vol + vol * kVolRow;
  const float qc[3] = {-rot[0], -rot[1], -rot[2]};   // the conjugate

  float hit_pos[3];
  for (int c = 0; c < 3; ++c) {
    hit_pos[c] = o_w[c] + t * d_w[c];
    h.so[c] = hit_pos[c] - d_w[c] * 0.1f;
    h.albedo[c] = mat[3 + c];
  }
  h.roughness = clamp01(mat[6]);
  h.metallic = clamp01(mat[7]);
  h.k = mat[8];
  float n_shade[3] = {n_obj[0], n_obj[1], n_obj[2]};

  if (kTextured && (kLit || !kColors)) {
    float a[3], obj_pos[3], b[3];
    for (int c = 0; c < 3; ++c) a[c] = (hit_pos[c] - pos[c]) / scale[c];
    rotate(qc, rot[3], a, obj_pos);
    // shade/texture.py _blend_weights
    const float ab[3] = {fabsf(n_obj[0]), fabsf(n_obj[1]), fabsf(n_obj[2])};
    const float s = (ab[0] + ab[1]) + ab[2];
    for (int c = 0; c < 3; ++c) b[c] = s > 0.0f ? ab[c] / s : 0.0f;
    const float* tscale = mat + 9;
    if (!kColors) {
      float tex[3];
      tri_sample<false>(p, sh_sizes, __float_as_int(mat[11]), tscale, obj_pos,
                        b, tex);
      for (int c = 0; c < 3; ++c) h.albedo[c] = h.albedo[c] * tex[c];
    }
    if (kLit) {
      float rm[3], tn[3];
      tri_sample<false>(p, sh_sizes, __float_as_int(mat[13]), tscale, obj_pos,
                        b, rm);
      h.roughness = clamp01(mat[6] * rm[0]);
      h.metallic = clamp01(mat[7] * rm[1]);
      tri_sample<true>(p, sh_sizes, __float_as_int(mat[12]), tscale, obj_pos,
                       b, tn);
      const float n2 = dot3(tn, tn);
      const float norm = sqrtf(n2 > 0.0f ? n2 : 1.0f);
      for (int c = 0; c < 3; ++c) tn[c] = n2 > 0.0f ? tn[c] / norm : 0.0f;
      const float zxy[3] = {tn[2], tn[0], tn[1]};
      rotate_from_x(n_obj, zxy, n_shade);
    }
  }

  if (kColors && kFwdColorSample) {
    // renderer.py _world_to_object, then the sample
    float a[3], b[3], o[3], d[3];
    for (int c = 0; c < 3; ++c) {
      a[c] = (o_w[c] - pos[c]) / scale[c];
      b[c] = d_w[c] / scale[c];
    }
    rotate(qc, rot[3], a, o);
    rotate(qc, rot[3], b, d);
    sample(vol, mat, o, d, t, h.albedo);
  }

  if (kLit) {
    // renderer.py _object_normal_to_world: rotated and scaled, not
    // renormalized
    rotate(rot, rot[3], n_shade, h.n_w);
    for (int c = 0; c < 3; ++c) h.n_w[c] = h.n_w[c] * scale[c];
  }
}

// surface_hit_from with the lane's t, instance and colour sample read from
// the surface kernels' inputs (the cell and the colour table in turn).
template <bool kLit, bool kTextured, bool kColors>
__device__ __forceinline__ void surface_hit(
    const SurfaceParams& p, const float* sh_inst, const float* sh_vol,
    const int* sh_sizes, long long i, const float o_w[3], const float d_w[3],
    const float n_obj[3], SurfaceHit& h) {
  surface_hit_from<kLit, kTextured, kColors>(
      p, sh_inst, sh_vol, sh_sizes, p.t[i], p.winner[i], o_w, d_w, n_obj,
      [&](int vol, const float* mat, const float o[3], const float d[3],
          float t, float out[3]) {
        color_sample(p, i, vol, __float_as_int(mat[0]), mat[1], mat[2], o, d,
                     t, out);
      },
      h);
}

// The mirror direction of d about n, normalised where it has a length
// (renderer.py _safe_unit).
__device__ __forceinline__ void mirror(const float d[3], const float n[3],
                                       float r[3]) {
  const float dn = 2.0f * dot3(d, n);
  for (int c = 0; c < 3; ++c) r[c] = d[c] - dn * n[c];
  const float n2 = dot3(r, r);
  const float norm = sqrtf(n2 > 0.0f ? n2 : 1.0f);
  for (int c = 0; c < 3; ++c) r[c] = n2 > 0.0f ? r[c] / norm : 0.0f;
}

// Point or spot light j's staged row (after the directional light's 4
// words); spot says which.
__device__ __forceinline__ const float* light_row(const float* sh_light,
                                                  const Lights& l, int j,
                                                  bool& spot) {
  spot = j >= l.points;
  return sh_light + 4 +
         (spot ? l.points * kPointRow + (j - l.points) * kSpotRow
               : j * kPointRow);
}

// Shadow ray j of a hit lane from its shadow origin so: the direction to
// the light and its t_max, the distance, or -inf where the light is too
// faint to be read.
__device__ __forceinline__ float shadow_ray(const float* sh_light,
                                           const Lights& l, int j,
                                           const float so[3], float sdir[3]) {
  bool spot;
  const float* row = light_row(sh_light, l, j, spot);
  float dist, inten;
  light_at(row, spot, so, sdir, dist, inten);
  return inten > (spot ? 0.01f : 0.005f) ? dist : -INFINITY;
}

// What a miss lane of a level that spawns traces writes, lane by lane:
// every reader discards a miss lane, but the seam still marches its rays:
// they keep the lane's own direction, which retires at the slab test with
// t_max = -inf (a zero direction would not); the material stays unwritten.
__device__ __forceinline__ void surface_miss_lane(const SurfaceParams& p,
                                                  long long i,
                                                  const float o_w[3],
                                                  const float d_w[3],
                                                  int n_shadow) {
  for (int c = 0; c < 3; ++c) {
    p.shadow_origin[3 * i + c] = o_w[c] - d_w[c] * 0.1f;
    if (p.bounce) p.refl_dir[3 * i + c] = d_w[c];
  }
  if (p.bounce) p.gate[i] = 0;
  if (p.shadows) {
    for (int j = 0; j <= n_shadow; ++j)
      p.shadow_tmax[j * p.rays + i] = -INFINITY;
    for (int j = 0; j < n_shadow; ++j)
      for (int c = 0; c < 3; ++c)
        p.shadow_dir[(j * p.rays + i) * 3 + c] = d_w[c];
  }
}

// A hit lane's record, mirror ray and shadow rays from its values h, lane by
// lane.
template <bool kLit>
__device__ __forceinline__ void surface_hit_lane(const SurfaceParams& p,
                                                 const float* sh_light,
                                                 long long i,
                                                 const float d_w[3],
                                                 const SurfaceHit& h,
                                                 int n_shadow) {
  store3(p.albedo, i, h.albedo);
  if (!kLit) return;
  store3(p.shadow_origin, i, h.so);
  store3(p.n_w, i, h.n_w);
  p.roughness[i] = h.roughness;
  p.metallic[i] = h.metallic;
  p.k[i] = h.k;

  if (p.bounce) {
    float r[3];
    mirror(d_w, h.n_w, r);
    store3(p.refl_dir, i, r);
    p.gate[i] = h.roughness < 0.3f ? 1 : 0;
  }

  if (p.shadows) {
    p.shadow_tmax[i] = kDirShadowTmax;
    for (int j = 0; j < n_shadow; ++j) {
      float sdir[3];
      p.shadow_tmax[(1 + j) * p.rays + i] =
          shadow_ray(sh_light, p.lights, j, h.so, sdir);
      for (int c = 0; c < 3; ++c)
        p.shadow_dir[(j * p.rays + i) * 3 + c] = sdir[c];
    }
  }
}

// The first design, kept as the comparator of the resident kernel below:
// one thread a ray over the whole grid, every block staging the tables and
// synchronising before its lanes read their flags, every access a lane's own
// 4-byte word.
template <bool kLit, bool kTextured, bool kColors>
__global__ void __launch_bounds__(kThreads) surface_kernel(
    const SurfaceParams p) {
  extern __shared__ float sh[];
  float* sh_inst = sh;
  float* sh_vol = sh_inst + p.inst.count * kInstRow;
  int* sh_sizes = reinterpret_cast<int*>(sh_vol + p.mat.count * kVolRow);
  float* sh_light = reinterpret_cast<float*>(sh_sizes + 2 * p.tex_count);
  stage_surface_tables(p, sh_inst, sh_vol, sh_sizes);
  if (kLit && p.shadows) stage_lights(sh_light, p.lights);
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.rays) return;
  const int n_shadow = p.lights.points + p.lights.spots;

  const bool hit = p.hit[i];
  // a miss lane of a level that spawns no trace has nothing to write
  if (!hit && !(kLit && (p.bounce || p.shadows))) return;

  float o_w[3], d_w[3];
  for (int c = 0; c < 3; ++c) {
    o_w[c] = p.o_w[3 * i + c];
    d_w[c] = p.d_w[3 * i + c];
  }

  if (!hit) {
    surface_miss_lane(p, i, o_w, d_w, n_shadow);
    return;
  }

  float n_obj[3];
  load3(p.n_obj, i, n_obj);
  SurfaceHit h;
  surface_hit<kLit, kTextured, kColors>(p, sh_inst, sh_vol, sh_sizes, i, o_w,
                                        d_w, n_obj, h);
  surface_hit_lane<kLit>(p, sh_light, i, d_w, h, n_shadow);
}

// ---- the forward pair's redesign ----------------------------------------------
//
// Resident blocks stride over the rays: the grid is the SMs times the blocks
// of the variant an SM holds at once (found once a variant), so the tables
// are staged once a resident block, not once every 256 rays.  A warp takes
// 32 consecutive rays a round.  On the vector path (kVec: every array it
// moves in 16-byte words starts on a 16-byte boundary, and the warp is
// whole) the warp's flags and, where the level spawns traces, its rays
// ([32,3] f32: 384 bytes) arrive by 16-byte cp.async into a ring of
// buffers in shared memory, a round ahead of the round being shaded:
// each round's loads are in flight together and ahead of their use, where
// a lane that loads its own flag and then its own ray waits for two
// dependent round trips to device memory before it stores.  At a level
// that spawns no trace there is no ray to fetch, and the flags of 16 of the
// warp's rounds come in one copy a lane.  A warp decides together
// (__ballot_sync): without a hit it writes only what the level's traces
// read, in 16-byte stores from its buffer, or nothing at a level that
// spawns none; with a hit, an output that every lane writes goes
// out in 16-byte stores through the warp's stage and the material, which a
// miss lane leaves unwritten, lane by lane unless every lane hit.  Each
// lane's values are the first design's, computed by the same functions.

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
// Blocks an SM must hold at once, register caps: the surface kernel at 80
// registers without spills, the combine kernel at 64 (above, the combine
// spills and loses; vrt_torch.apps.probe_caps times them).
constexpr int kSurfaceMinBlocks = 3;
constexpr int kCombineMinBlocks = 4;
// The probe's comparisons, never changed here: false runs the redesign over
// the first design's grid, one thread a ray; false compiles the hit lanes'
// work out of both kernels (every lane shades as a miss).
constexpr bool kFwdResident = true;
constexpr bool kFwdHitPath = true;

// 16 bytes from device memory into shared memory, asynchronously; a round's
// copies are committed together and waited for with the round after them
// in flight.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

// The warp's span of an [R,3] f32 array (rays w0 .. w0 + 31) as 24 float4s
// through the warp's 384-byte stage: each lane ends with its own ray's
// three floats.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_load3(float* stage, const float* src,
                                           long long w0, int lane,
                                           float v[3]) {
  if (lane < 24)
    reinterpret_cast<float4*>(stage)[lane] =
        reinterpret_cast<const float4*>(src + 3 * w0)[lane];
  __syncwarp();
  for (int c = 0; c < 3; ++c) v[c] = stage[3 * lane + c];
  __syncwarp();
}

// Each lane's three floats into the warp's span of dst as 24 float4s.
__device__ __forceinline__ void warp_store3(float* stage, float* dst,
                                            long long w0, int lane,
                                            const float v[3]) {
  for (int c = 0; c < 3; ++c) stage[3 * lane + c] = v[c];
  __syncwarp();
  if (lane < 24)
    reinterpret_cast<float4*>(dst + 3 * w0)[lane] =
        reinterpret_cast<const float4*>(stage)[lane];
  __syncwarp();
}

// What a surface warp fetches ahead: its 32 flags and, where the level
// spawns traces, its rays.
struct SurfaceFetch {
  float4 o[24];
  float4 d[24];
  uint8_t flags[32];
};

// A surface warp's buffers in shared memory: the round it shades and the
// rounds fetched ahead of it (one ahead measured fastest: two add 9
// registers and gain nothing; vrt_torch.apps.probe_caps).
constexpr int kFetchDepth = 2;

// The fetch of the round whose first ray in this block is `base`, into
// `f`, on the vector path only (else the lanes load their own).
__device__ __forceinline__ void surface_fetch(const SurfaceParams& p,
                                              bool spawns, long long base,
                                              int lane, SurfaceFetch& f) {
  const long long w0 = base + (threadIdx.x & ~31);
  if (w0 + 32 > p.rays) return;
  if (lane < 2) copy16(f.flags + 16 * lane, p.hit + w0 + 16 * lane);
  if (spawns && lane < 24) {
    copy16(&f.o[lane], p.o_w + 3 * w0 + 4 * lane);
    copy16(&f.d[lane], p.d_w + 3 * w0 + 4 * lane);
  }
}

// The rounds of a warp whose flags come in one batch at a level that spawns
// no trace (at most 16: two lanes a round).
constexpr int kFlagRounds = 16;

// The flags of the kFlagRounds rounds of this warp from the round whose
// first ray in the block is `base`: lane l copies 16 of round l / 2's 32.
// A round past the end, or whose warp is partial, is not fetched (its
// lanes load their own).
__device__ __forceinline__ void flag_fetch(const SurfaceParams& p,
                                           long long base, long long stride,
                                           int warp, int lane,
                                           uint8_t (*batch)[32]) {
  const long long w0 = base + (lane >> 1) * stride + 32 * warp;
  if ((lane >> 1) < kFlagRounds && w0 + 32 <= p.rays)
    copy16(batch[lane >> 1] + 16 * (lane & 1), p.hit + w0 + 16 * (lane & 1));
}

// A warp without a hit at a level that spawns traces, on the vector path:
// the shadow origin o - 0.1 d, the mirror ray along d behind a closed gate,
// and every shadow along d with t_max = -inf, as the first design's miss
// lanes write them, from the rays in the warp's buffer.
__device__ __forceinline__ void surface_miss_warp(const SurfaceParams& p,
                                                  const SurfaceFetch& f,
                                                  long long w0, int lane,
                                                  int n_shadow) {
  if (lane < 24) {
    const float4 o = f.o[lane];
    const float4 d = f.d[lane];
    reinterpret_cast<float4*>(p.shadow_origin + 3 * w0)[lane] =
        make_float4(o.x - d.x * 0.1f, o.y - d.y * 0.1f, o.z - d.z * 0.1f,
                    o.w - d.w * 0.1f);
    if (p.bounce) reinterpret_cast<float4*>(p.refl_dir + 3 * w0)[lane] = d;
    if (p.shadows)
      for (int j = 0; j < n_shadow; ++j)
        reinterpret_cast<float4*>(p.shadow_dir + 3 * (j * p.rays + w0))
            [lane] = d;
  }
  if (p.bounce) p.gate[w0 + lane] = 0;
  if (p.shadows)
    for (int j = 0; j <= n_shadow; ++j)
      p.shadow_tmax[j * p.rays + w0 + lane] = -INFINITY;
}

// One round of a surface warp: the 32 rays from w0 (a multiple of 32), the
// lane's ray w0 + lane.  On the vector path `flags` holds the round's 32
// flags and, where the level spawns traces, `f` its rays, both fetched
// ahead into shared memory; else the lanes load their own (a whole warp
// that hits everywhere through the stage).  Every lane of the warp calls
// it.
template <bool kLit, bool kTextured, bool kColors>
__device__ __forceinline__ void surface_round(
    const SurfaceParams& p, const float* sh_inst, const float* sh_vol,
    const int* sh_sizes, const float* sh_light, float* stage,
    const uint8_t* flags, const SurfaceFetch* f, long long w0, int lane,
    bool vec, bool spawns, int n_shadow) {
  const long long i = w0 + lane;
  const bool in = i < p.rays;
  const bool flag = flags != nullptr ? flags[lane] != 0 : in && p.hit[i];
  const bool is_hit = kFwdHitPath && flag;
  const unsigned hits = __ballot_sync(kFullWarp, is_hit);
  if (hits == 0u && !spawns) return;          // nothing to write
  if (hits == 0u && f != nullptr) {
    surface_miss_warp(p, *f, w0, lane, n_shadow);
    return;
  }
  const bool all_hit = hits == kFullWarp;
  // the ray where the lane writes a trace or shades
  const bool mine = is_hit || (in && spawns);
  float o_w[3] = {0.0f, 0.0f, 0.0f}, d_w[3] = {0.0f, 0.0f, 0.0f};
  float n_obj[3] = {0.0f, 0.0f, 0.0f};
  if (f != nullptr) {
    const float* o = reinterpret_cast<const float*>(f->o);
    const float* d = reinterpret_cast<const float*>(f->d);
    for (int c = 0; c < 3; ++c) {
      o_w[c] = o[3 * lane + c];
      d_w[c] = d[3 * lane + c];
    }
  } else if (vec && all_hit) {
    warp_load3(stage, p.o_w, w0, lane, o_w);
    warp_load3(stage, p.d_w, w0, lane, d_w);
  } else if (mine) {
    load3(p.o_w, i, o_w);
    load3(p.d_w, i, d_w);
  }
  if (vec && all_hit) warp_load3(stage, p.n_obj, w0, lane, n_obj);
  else if (is_hit) load3(p.n_obj, i, n_obj);
  SurfaceHit h = {};
  if (is_hit)
    surface_hit<kLit, kTextured, kColors>(p, sh_inst, sh_vol, sh_sizes, i,
                                          o_w, d_w, n_obj, h);
  // an [R,3] output in 16-byte stores where every lane of a whole warp
  // writes it, else by the lanes that do
  auto put3 = [&](float* dst, const float v[3], bool every, bool own) {
    if (vec && every) warp_store3(stage, dst, w0, lane, v);
    else if (own) store3(dst, i, v);
  };
  put3(p.albedo, h.albedo, all_hit, is_hit);
  if (!kLit) return;
  float so[3];
  for (int c = 0; c < 3; ++c)
    so[c] = is_hit ? h.so[c] : o_w[c] - d_w[c] * 0.1f;
  put3(p.shadow_origin, so, spawns || all_hit, mine);
  put3(p.n_w, h.n_w, all_hit, is_hit);
  if (is_hit) {
    p.roughness[i] = h.roughness;
    p.metallic[i] = h.metallic;
    p.k[i] = h.k;
  }
  if (p.bounce) {
    float r[3];
    if (is_hit) mirror(d_w, h.n_w, r);
    else for (int c = 0; c < 3; ++c) r[c] = d_w[c];
    put3(p.refl_dir, r, true, in);
    if (in) p.gate[i] = is_hit && h.roughness < 0.3f ? 1 : 0;
  }
  if (p.shadows) {
    if (in) p.shadow_tmax[i] = is_hit ? kDirShadowTmax : -INFINITY;
    for (int j = 0; j < n_shadow; ++j) {
      float sdir[3] = {d_w[0], d_w[1], d_w[2]};
      const float tm = is_hit
                           ? shadow_ray(sh_light, p.lights, j, h.so, sdir)
                           : -INFINITY;
      if (in) p.shadow_tmax[(1 + j) * p.rays + i] = tm;
      put3(p.shadow_dir + 3 * j * p.rays, sdir, true, in);
    }
  }
}

template <bool kLit, bool kTextured, bool kColors, bool kVec>
__global__ void __launch_bounds__(kFwdThreads, kSurfaceMinBlocks)
    surface_resident_kernel(const SurfaceParams p) {
  extern __shared__ float sh[];
  __shared__ float4 stages[kFwdWarps][24];
  __shared__ SurfaceFetch fetched[kFwdWarps][kFetchDepth];
  __shared__ __align__(16) uint8_t flag_batches[kFwdWarps][2][kFlagRounds][32];
  float* sh_inst = sh;
  float* sh_vol = sh_inst + p.inst.count * kInstRow;
  int* sh_sizes = reinterpret_cast<int*>(sh_vol + p.mat.count * kVolRow);
  float* sh_light = reinterpret_cast<float*>(sh_sizes + 2 * p.tex_count);
  stage_surface_tables(p, sh_inst, sh_vol, sh_sizes);
  if (kLit && p.shadows) stage_lights(sh_light, p.lights);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = reinterpret_cast<float*>(stages[warp]);
  SurfaceFetch* buf = fetched[warp];
  const bool spawns = kLit && (p.bounce || p.shadows);
  const int n_shadow = p.lights.points + p.lights.spots;
  const long long stride = static_cast<long long>(gridDim.x) * kFwdThreads;
  long long base = static_cast<long long>(blockIdx.x) * kFwdThreads;

  if (kVec && !spawns) {
    // nothing to write on a miss lane, and no ray to fetch: the warp's
    // flags of kFlagRounds of its rounds come in one 16-byte copy a lane
    // (two lanes a round), the next batch's while this batch's rounds are
    // shaded
    uint8_t(*batches)[kFlagRounds][32] = flag_batches[warp];
    flag_fetch(p, base, stride, warp, lane, batches[0]);
    __pipeline_commit();
    for (int round = 0; base < p.rays; base += stride, ++round) {
      const int k = round % kFlagRounds;
      const int batch = (round / kFlagRounds) & 1;
      if (k == 0) {
        __syncwarp();
        flag_fetch(p, base + kFlagRounds * stride, stride, warp, lane,
                   batches[batch ^ 1]);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncwarp();
      }
      const long long w0 = base + 32 * warp;
      const bool vec = w0 + 32 <= p.rays;
      surface_round<kLit, kTextured, kColors>(
          p, sh_inst, sh_vol, sh_sizes, sh_light, stage,
          vec ? batches[batch][k] : nullptr, nullptr, w0, lane, vec, false,
          n_shadow);
    }
    return;
  }

  for (int k = 0; k + 1 < kFetchDepth; ++k) {
    if (kVec) surface_fetch(p, spawns, base + k * stride, lane, buf[k]);
    __pipeline_commit();
  }
  for (int round = 0; base < p.rays; base += stride, ++round) {
    // every lane is done with the buffer of the round before: fetch the
    // round kFetchDepth - 1 ahead into it, then wait for this round's
    // copies
    __syncwarp();
    if (kVec)
      surface_fetch(p, spawns, base + (kFetchDepth - 1) * stride, lane,
                    buf[(round + kFetchDepth - 1) % kFetchDepth]);
    __pipeline_commit();
    __pipeline_wait_prior(kFetchDepth - 1);
    __syncwarp();
    const long long w0 = base + 32 * warp;      // the warp's first ray
    // the vector path takes whole warps; a last partial warp goes lane by
    // lane
    const bool vec = kVec && w0 + 32 <= p.rays;
    const SurfaceFetch* f = vec ? &buf[round % kFetchDepth] : nullptr;
    surface_round<kLit, kTextured, kColors>(
        p, sh_inst, sh_vol, sh_sizes, sh_light, stage,
        f != nullptr ? f->flags : nullptr, f, w0, lane, vec, spawns,
        n_shadow);
  }
}

// ---- the surface on the unpacked voxel grid ---------------------------------
//
// Colour layout 2, the f32 voxel grid that vrt leaves unpacked above its
// COLOR_CORNER_BUDGET_BYTES (config4's 257^3 colours, 204 MB), samples 8
// voxel rows of 3 a hit, 4 z-adjacent pairs of 24 contiguous bytes, 3 KB
// apart in y and 792 KB apart in x.  Its launches are small: a view of
// 65,536 rays is 256 blocks, under one wave of the card, so each thread
// shades one ray and the resident kernel's fetch-ahead ring overlaps
// nothing.  What sets their time is a hit lane's chain of dependent loads:
// the flag, then the ray, then the normal, t and instance, then the texture
// samples, then the cell (color_sample reads it), then the colours it
// names, then the stores; at config4 the gather at the chain's end was more
// than a third of the launch (apps/probe_caps.py shade_fwd, the colour
// sample compiled out).  This design, one thread a ray over the whole grid,
// loads every input of a lane at once (its flag, t, instance, cell, ray and
// normal) and the 24 colour loads together where the sample starts: the
// cell is in hand by then, so the gather costs one round trip.  Measured
// and no faster (PERF.md, section 6): the lane's loads issued before the
// block stages its tables, the colour loads issued before the texture
// samples, 8-byte loads of a z-pair, register caps, 128 threads; the loads
// gated on the flag lose from a wave up (kVoxelGated).  It is the fastest
// design measured on the unpacked grid at every launch size, so the wrapper
// takes it for every launch there.  The arithmetic and its order are the
// first design's (surface_hit_from, the trilinear sum in j order, the stores
// of surface_kernel): every lane it writes is bit-equal to the first
// design's.

constexpr int kVoxelThreads = 256;
// Blocks an SM must hold at once: 1 leaves the registers uncapped
// (vrt_torch.apps.probe_caps surface_voxels times the others).
constexpr int kVoxelMinBlocks = 1;
// The probe's comparison, never changed here: true loads a lane's inputs
// after its flag, and a miss lane's only where it writes a trace's ray.
constexpr bool kVoxelGated = false;

template <bool kLit, bool kTextured>
__global__ void __launch_bounds__(kVoxelThreads, kVoxelMinBlocks)
    surface_voxels_kernel(const SurfaceParams p) {
  extern __shared__ float sh[];
  float* sh_inst = sh;
  float* sh_vol = sh_inst + p.inst.count * kInstRow;
  int* sh_sizes = reinterpret_cast<int*>(sh_vol + p.mat.count * kVolRow);
  float* sh_light = reinterpret_cast<float*>(sh_sizes + 2 * p.tex_count);
  stage_surface_tables(p, sh_inst, sh_vol, sh_sizes);
  if (kLit && p.shadows) stage_lights(sh_light, p.lights);
  __syncthreads();

  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.rays) return;
  // every input of the lane at once, its flag among them: the cell too,
  // which the first design reads only after the texture samples
  const bool hit = kFwdHitPath && p.hit[i];
  const bool spawns = kLit && (p.bounce || p.shadows);
  float t = 0.0f;
  int winner = 0, cell[3] = {0, 0, 0};
  float o_w[3] = {0.0f, 0.0f, 0.0f}, d_w[3] = {0.0f, 0.0f, 0.0f};
  float n_obj[3] = {0.0f, 0.0f, 0.0f};
  if (!kVoxelGated || hit || spawns)
    for (int c = 0; c < 3; ++c) {
      o_w[c] = p.o_w[3 * i + c];
      d_w[c] = p.d_w[3 * i + c];
    }
  if (!kVoxelGated || hit) {
    t = p.t[i];
    winner = p.winner[i];
    for (int c = 0; c < 3; ++c) {
      cell[c] = p.cell[3 * i + c];
      n_obj[c] = p.n_obj[3 * i + c];
    }
  }
  const int n_shadow = p.lights.points + p.lights.spots;
  if (!hit) {
    // a miss lane of a level that spawns no trace has nothing to write
    if (spawns) surface_miss_lane(p, i, o_w, d_w, n_shadow);
    return;
  }
  SurfaceHit h;
  surface_hit_from<kLit, kTextured, true>(
      p, sh_inst, sh_vol, sh_sizes, t, winner, o_w, d_w, n_obj,
      [&](int vol, const float* mat, const float o[3], const float d[3],
          float t_hit, float out[3]) {
        float corners[8][3];
        voxel_corners(p, vol, __float_as_int(mat[0]), cell, corners);
        voxel_trilinear(cell, mat[1], mat[2], o, d, t_hit, corners, out);
      },
      h);
  surface_hit_lane<kLit>(p, sh_light, i, d_w, h, n_shadow);
}

// ---- combine ----------------------------------------------------------------

struct CombineParams {
  const float* d_w;            // [R,3]
  const float* n_obj;          // [R,3]
  const uint8_t* hit;          // [R] bool
  const uint8_t* unlit;        // [R] bool
  const float* albedo;         // [R,3]
  const float* shadow_origin;  // [R,3]
  const float* n_w;            // [R,3]
  const float* roughness;      // [R]
  const float* metallic;       // [R]
  const float* k;              // [R]
  const float* refl_dir;       // [R,3] with a bounce
  const float* refl_rgb;       // [R,3] with a bounce, else null
  const uint8_t* blocked[kMaxBlocked];  // [R] bool per light, or all null
  Lights lights;
  const float* env;            // [6,E,E,3]
  int env_side;
  int lit, final;
  long long rays;
  float* out;                  // [R,3], or [R,4] with final
};

// shade/brdf.py radiance: brdf * li * (n . wi).
__device__ __forceinline__ void add_radiance(const float li[3],
                                             const float wi[3],
                                             const float wo[3],
                                             const float n[3],
                                             const float albedo[3],
                                             float roughness, float metallic,
                                             float k, float out[3]) {
  float h[3];
  for (int c = 0; c < 3; ++c) h[c] = wi[c] + wo[c];
  const float n2 = dot3(h, h);
  const float norm = sqrtf(n2 > 0.0f ? n2 : 1.0f);
  for (int c = 0; c < 3; ++c) h[c] = n2 > 0.0f ? h[c] / norm : 0.0f;
  // distribution_ggx
  const float a2 = roughness * roughness;
  const float ndoth = nmax(dot3(n, h), 0.0f);
  const float cc = (ndoth * ndoth) * (a2 - 1.0f) + 1.0f;
  const float dist = a2 / nmax((kPi * cc) * cc, 0.001f);
  // fresnel_schlick's scalar factor
  const float wdoth = nmax(dot3(wo, h), 0.0f);
  const float pw = powf(nmax(1.0f - wdoth, 0.0f), 5.0f);
  // g_smith
  const float dwo = nmax(dot3(n, wo), 0.0f);
  const float dwi = nmax(dot3(n, wi), 0.0f);
  const float g = (dwo / (dwo * (1.0f - k) + k)) *
                  (dwi / (dwi * (1.0f - k) + k));
  const float denom = nmax((4.0f * dwo) * dwi, 0.0001f);
  const float spec = (dist * g) / denom;
  const float ndotwi = dot3(n, wi);
  const float dielectric = 1.0f - metallic;
  for (int c = 0; c < 3; ++c) {
    const float f0 = kF0Diel * dielectric + albedo[c] * metallic;
    const float f = f0 + (1.0f - f0) * pw;
    const float lambert = albedo[c] / kPi;
    const float kd = (1.0f - f) * dielectric;
    const float brdf = lambert * kd + (spec * f) * f;
    out[c] = (brdf * li[c]) * ndotwi;
  }
}

// shade/texture.py sample_env: the cube lookup with the direction swizzled
// .xzy, D3D face and uv conventions, bilinear within the face.
__device__ __forceinline__ void sample_env(const float* env, int e,
                                           const float d_w[3], float out[3]) {
  const float x = d_w[0], y = d_w[2], z = d_w[1];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool x_major = ax >= ay && ax >= az;
  const bool y_major = !x_major && ay >= az;
  float ma, sc, tc;
  int face;
  if (x_major) {
    ma = ax;
    face = x >= 0.0f ? 0 : 1;
    sc = x >= 0.0f ? -z : z;
    tc = -y;
  } else if (y_major) {
    ma = ay;
    face = y >= 0.0f ? 2 : 3;
    sc = x;
    tc = y >= 0.0f ? z : -z;
  } else {
    ma = az;
    face = z >= 0.0f ? 4 : 5;
    sc = z >= 0.0f ? x : -x;
    tc = -y;
  }
  const float fe = static_cast<float>(e);
  const float u = (((sc / ma) + 1.0f) * 0.5f) * fe - 0.5f;
  const float v = (((tc / ma) + 1.0f) * 0.5f) * fe - 0.5f;
  const float u0 = floorf(u), v0 = floorf(v);
  const float fu = u - u0, fv = v - v0;
  const int ua = min(max(static_cast<int>(u0), 0), e - 1);
  const int ub = min(max(static_cast<int>(u0 + 1.0f), 0), e - 1);
  const int va = min(max(static_cast<int>(v0), 0), e - 1);
  const int vb = min(max(static_cast<int>(v0 + 1.0f), 0), e - 1);
  const float* base = env + static_cast<long long>(face) * e * e * 3;
  const float* c00 = base + (va * e + ua) * 3;
  const float* c10 = base + (va * e + ub) * 3;
  const float* c01 = base + (vb * e + ua) * 3;
  const float* c11 = base + (vb * e + ub) * 3;
  const float gu = 1.0f - fu, gv = 1.0f - fv;
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(c00 + c) * gu + __ldg(c10 + c) * fu;
    const float bot = __ldg(c01 + c) * gu + __ldg(c11 + c) * fu;
    out[c] = top * gv + bot * fv;
  }
}

// One lane's linear radiance (the redesign of the combine kernel; the first
// design below keeps its own copy of the same lines, as it was measured):
// the env on a miss lane, the attribute normal on an unlit-attribute lane,
// the albedo unlit, else the mirror term and the lights from the record,
// which only a hit lane reads.
__device__ __forceinline__ void combine_rgb(const CombineParams& p,
                                            const float* sh, long long i,
                                            const float d_w[3], bool hit,
                                            bool unlit, float rgb[3]) {
  if (!hit) {
    sample_env(p.env, p.env_side, d_w, rgb);
  } else if (unlit) {
    // unlit-attribute lanes show the raw (object-space) attribute normal
    for (int c = 0; c < 3; ++c) rgb[c] = p.n_obj[3 * i + c];
  } else if (!p.lit) {
    for (int c = 0; c < 3; ++c) rgb[c] = p.albedo[3 * i + c];
  } else {
    float albedo[3], so[3], n_w[3], wo[3], add[3];
    for (int c = 0; c < 3; ++c) {
      albedo[c] = p.albedo[3 * i + c];
      so[c] = p.shadow_origin[3 * i + c];
      n_w[c] = p.n_w[3 * i + c];
      wo[c] = -d_w[c];
      rgb[c] = kShadowBrightness;
    }
    const float roughness = p.roughness[i], metallic = p.metallic[i];
    const float k = p.k[i];

    if (p.refl_rgb != nullptr) {
      float li[3], wi[3];
      const float fade = 1.0f - roughness * 2.2f;
      for (int c = 0; c < 3; ++c) {
        li[c] = nmax(p.refl_rgb[3 * i + c] * fade, 0.0f);
        wi[c] = p.refl_dir[3 * i + c];
      }
      add_radiance(li, wi, wo, n_w, albedo, roughness, metallic, k, add);
      for (int c = 0; c < 3; ++c)
        rgb[c] = rgb[c] + (roughness < 0.3f ? add[c] : 0.0f);
    }

    {
      const float li[3] = {sh[3], sh[3], sh[3]};
      add_radiance(li, sh, wo, n_w, albedo, roughness, metallic, k, add);
      const bool dark = p.blocked[0] != nullptr && p.blocked[0][i];
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + (dark ? 0.0f : add[c]);
    }

    const int n_shadow = p.lights.points + p.lights.spots;
    for (int j = 0; j < n_shadow; ++j) {
      bool spot;
      const float* row = light_row(sh, p.lights, j, spot);
      float sdir[3], dist, inten, li[3];
      light_at(row, spot, so, sdir, dist, inten);
      const float* color = row + (spot ? 11 : 6);
      for (int c = 0; c < 3; ++c) li[c] = color[c] * inten;
      add_radiance(li, sdir, wo, n_w, albedo, roughness, metallic, k, add);
      bool lit = inten > (spot ? 0.01f : 0.005f);
      if (p.blocked[1 + j] != nullptr) lit = lit && !p.blocked[1 + j][i];
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + (lit ? add[c] : 0.0f);
    }
  }
}

// renderer.py tonemap: Reinhard, gamma 1/2.2, then the UNORM conversion (NaN
// and negative radiance to 0, clamp to [0, 1]); alpha 1 (the redesign's;
// the first design writes the same lines inline).
__device__ __forceinline__ float4 tonemap_px(const float rgb[3]) {
  float px[3];
  for (int c = 0; c < 3; ++c) {
    const float v = rgb[c] / (rgb[c] + 1.0f);
    px[c] = v > 0.0f ? fminf(powf(v, static_cast<float>(1.0 / 2.2)), 1.0f)
                     : 0.0f;
  }
  return make_float4(px[0], px[1], px[2], 1.0f);
}

// The first design, kept as the comparator of the resident kernel below:
// one thread a ray over the whole grid, every block staging the lights.
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const CombineParams p) {
  extern __shared__ float sh[];
  if (p.lit) stage_lights(sh, p.lights);
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.rays) return;

  float d_w[3], rgb[3];
  for (int c = 0; c < 3; ++c) d_w[c] = p.d_w[3 * i + c];

  if (!p.hit[i]) {
    sample_env(p.env, p.env_side, d_w, rgb);
  } else if (p.unlit[i]) {
    // unlit-attribute lanes show the raw (object-space) attribute normal
    for (int c = 0; c < 3; ++c) rgb[c] = p.n_obj[3 * i + c];
  } else if (!p.lit) {
    for (int c = 0; c < 3; ++c) rgb[c] = p.albedo[3 * i + c];
  } else {
    float albedo[3], so[3], n_w[3], wo[3], add[3];
    for (int c = 0; c < 3; ++c) {
      albedo[c] = p.albedo[3 * i + c];
      so[c] = p.shadow_origin[3 * i + c];
      n_w[c] = p.n_w[3 * i + c];
      wo[c] = -d_w[c];
      rgb[c] = kShadowBrightness;
    }
    const float roughness = p.roughness[i], metallic = p.metallic[i];
    const float k = p.k[i];

    if (p.refl_rgb != nullptr) {
      float li[3], wi[3];
      const float fade = 1.0f - roughness * 2.2f;
      for (int c = 0; c < 3; ++c) {
        li[c] = nmax(p.refl_rgb[3 * i + c] * fade, 0.0f);
        wi[c] = p.refl_dir[3 * i + c];
      }
      add_radiance(li, wi, wo, n_w, albedo, roughness, metallic, k, add);
      for (int c = 0; c < 3; ++c)
        rgb[c] = rgb[c] + (roughness < 0.3f ? add[c] : 0.0f);
    }

    {
      const float li[3] = {sh[3], sh[3], sh[3]};
      add_radiance(li, sh, wo, n_w, albedo, roughness, metallic, k, add);
      const bool dark = p.blocked[0] != nullptr && p.blocked[0][i];
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + (dark ? 0.0f : add[c]);
    }

    const int n_shadow = p.lights.points + p.lights.spots;
    for (int j = 0; j < n_shadow; ++j) {
      const bool spot = j >= p.lights.points;
      const float* row =
          sh + 4 +
          (spot ? p.lights.points * kPointRow +
                      (j - p.lights.points) * kSpotRow
                : j * kPointRow);
      float sdir[3], dist, inten, li[3];
      light_at(row, spot, so, sdir, dist, inten);
      const float* color = row + (spot ? 11 : 6);
      for (int c = 0; c < 3; ++c) li[c] = color[c] * inten;
      add_radiance(li, sdir, wo, n_w, albedo, roughness, metallic, k, add);
      bool lit = inten > (spot ? 0.01f : 0.005f);
      if (p.blocked[1 + j] != nullptr) lit = lit && !p.blocked[1 + j][i];
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + (lit ? add[c] : 0.0f);
    }
  }

  if (!p.final) {
    for (int c = 0; c < 3; ++c) p.out[3 * i + c] = rgb[c];
    return;
  }
  // renderer.py tonemap: Reinhard, gamma 1/2.2, then the UNORM conversion
  // (NaN and negative radiance to 0, clamp to [0, 1])
  float px[4];
  for (int c = 0; c < 3; ++c) {
    const float v = rgb[c] / (rgb[c] + 1.0f);
    px[c] = v > 0.0f ? fminf(powf(v, static_cast<float>(1.0 / 2.2)), 1.0f)
                     : 0.0f;
  }
  px[3] = 1.0f;
  *reinterpret_cast<float4*>(p.out + 4 * i) =
      make_float4(px[0], px[1], px[2], px[3]);
}

// The redesign: resident blocks; on the vector path a warp's hit and unlit
// flags from one load of sixteen 4-byte words, its directions and linear
// radiance in 16-byte words through its stage.  The frame's [R,4] pixels go
// out one float4 a lane, as in the first design.
template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads, kCombineMinBlocks)
    combine_resident_kernel(const CombineParams p) {
  extern __shared__ float sh[];
  __shared__ float4 stages[kFwdWarps][24];
  if (p.lit) stage_lights(sh, p.lights);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(stages[threadIdx.x >> 5]);
  const long long stride = static_cast<long long>(gridDim.x) * kFwdThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kFwdThreads;
       base < p.rays; base += stride) {
    const long long i = base + threadIdx.x;
    const long long w0 = i - lane;
    const bool in = i < p.rays;
    float d_w[3], rgb[3];
    if (kVec && w0 + 32 <= p.rays) {
      // lanes 0-7 read the hit flags' words, lanes 8-15 the unlit flags'
      const uint8_t* flags = (lane < 8 ? p.hit : p.unlit) + w0;
      const uint32_t w =
          lane < 16 ? reinterpret_cast<const uint32_t*>(flags)[lane & 7] : 0u;
      const uint32_t hw = __shfl_sync(kFullWarp, w, lane >> 2);
      const uint32_t uw = __shfl_sync(kFullWarp, w, 8 + (lane >> 2));
      const bool hit =
          kFwdHitPath && ((hw >> (8 * (lane & 3))) & 0xffu) != 0u;
      const bool unlit = ((uw >> (8 * (lane & 3))) & 0xffu) != 0u;
      warp_load3(stage, p.d_w, w0, lane, d_w);
      combine_rgb(p, sh, i, d_w, hit, hit && unlit, rgb);
      if (p.final)
        reinterpret_cast<float4*>(p.out)[i] = tonemap_px(rgb);
      else
        warp_store3(stage, p.out, w0, lane, rgb);
      continue;
    }
    if (!in) continue;
    load3(p.d_w, i, d_w);
    const bool hit = kFwdHitPath && p.hit[i];
    combine_rgb(p, sh, i, d_w, hit, hit && p.unlit[i], rgb);
    if (p.final)
      reinterpret_cast<float4*>(p.out)[i] = tonemap_px(rgb);
    else
      for (int c = 0; c < 3; ++c) p.out[3 * i + c] = rgb[c];
  }
}

// ---- backward ---------------------------------------------------------------
//
// The transpose of each stage, one thread a ray, as autograd differentiates
// the plain stages (the plain versions of the two kernels below are
// renderer.py shade_surface_backward_reference / shade_combine_backward_
// reference, which are that autograd).  Each recomputes its stage's terms
// from the stage's inputs (nothing but the inputs is saved) and pulls the
// cotangents back through them in registers.  Every cotangent but the colour
// table's belongs to one ray, so only the colour rows need atomics.
//
// The surface backward has two designs.  The first (surface_bwd_kernel):
// one thread a ray over a grid of 8,100 blocks at 1080p, each block staging
// the tables and synchronising before its lanes read their flags, each hit
// lane issuing its six 16-byte reductions on its own.  What held it back on
// the H100 (chip_smoke.py; ncu cannot run there): on config6's primary rays
// 118,053 hits fall on 3,024 colour rows, 26 hits and 5.5 rows a warp, and
// yet the launch without the colour table's cotangent is faster by little
// more than the 53 MB accumulator's zero fill: the reductions were not what
// held it back.  The hit lanes' recomputation is, latency-bound at 97-125 registers
// (16 of 64 warp slots); the launches with few hits cost their 2 M flags
// and 40 B of zeros a lane.  The redesign (surface_bwd_merged_kernel, the
// default, below) keeps blocks resident and striding, writes an all-miss
// warp's zeros in 16-byte stores, merges a warp's colour-row cotangents
// before the reductions, and caps the registers at 80 (3 blocks an SM): of
// the probe's builds the fastest over a step's three launches.  The combine
// backward has two designs too (combine_bwd_kernel, the first, and
// combine_bwd_resident_kernel, the default; see "combine backward, the
// redesign" below).
//
// Each backward kernel has a variant that also differentiates the scene's
// small tables, a compile-time instantiation (kMat, kGrad) that the wrapper
// picks only where one of them needs a gradient; no default launch runs any
// of their code.  The surface backward's material
// variant adds, per hit lane, the cotangents of its volume's tint (the
// albedo's, times the albedo texture where textured; none under per-voxel
// colours), roughness and metallic (through the clip and the rm texture)
// and k (the record's k's); the combine backward's light variant returns
// the record's k's per lane (g_schlick's) and adds each lit lane's
// cotangents of the directional light (direction, strength) and of each
// point and spot light's row (position, intensity, attenuations, colour,
// and a spot light's forward direction and cone).  Those tables are small
// (at most 20 volumes x 7 floats, 4 + 5 x 9 + 5 x 14 light floats) and every
// hit lane adds into them: each block keeps its partial sums in shared
// memory (beside the staged tables), merged first over the lanes of a warp
// (the material's by volume with merge_peers; a light's on the combine
// backward's vector path, where the warp runs the lit lanes' code
// together, by a shuffle tree, measured 2.6x faster than each lane's shared
// atomics there), and adds them into an f32
// accumulator once, at its end: one atomic a nonzero entry a block.  What
// they add to a launch: a lane's few more products and the reductions; the
// bytes are the default's but for the record's k.
//
// Two more variants differentiate the sampled tables, each a kernel of its
// own (surface_bwd_textures_kernel, combine_bwd_env_kernel: the merged and
// the resident kernel's bodies with kTex / kEnv), so that the default
// launches' kernels compile as they did; either joins its kernel's other
// variant in one launch.  The surface backward's texture variant (a
// textured mode) adds, per hit lane, the texture scale's cotangents of its
// volume (uv = pos / scale, through every sample the lane takes: the
// albedo's unless per-voxel colours replace it, the roughness / metallic
// and the normal texture's) into the block's partial sums beside the
// material's, and the cotangents of its 12 taps a sample (the bilinear
// weights times the sample's cotangent) into the stacked textures; the
// combine backward's env variant adds a miss lane's four taps into the env
// cube.  Those tables are larger (the shading scene's 3 x 16 x 16 texels, a
// cube of 6 x E x E) and a tap is a gather of its own, so a warp's lanes
// that name one texel are summed first and the lowest adds the sum into the
// block's partial sums in shared memory, added into the table once at the
// block's end, where the table fits kTexSharedBytes / kEnvSharedBytes, else
// into the table's f32 accumulator by f32 atomics; the padding of the
// stacked textures gets no tap.  The first design (surface_bwd_textures_
// kernel, combine_bwd_env_kernel) merges each tap on its own inside the
// lanes' code (add_texel: merge_peers over the lanes active there); the
// redesign (surface_bwd_textures_warp_kernel, combine_bwd_env_warp_kernel,
// the default; see "the texture and env variants' taps, the redesign")
// sums a sample's four taps over the whole warp at once.
//
// The surface backward's instance variant (surface_bwd_instances_kernel:
// the merged kernel's body with kInst, and with kMat / kTex where the step
// also asks for the material or the texture variant, one launch of all)
// adds, per hit lane, the cotangents of its instance transform (pos 3, rot
// 4, scale 3) from the three places the stage reads it: the textures'
// object-space hit point, the colour sample's object-space ray (scene.cuh
// object_bwd) and the world normal n_w = rotate(rot, n_shade) * scale
// (rotate_bwd); a warp's lanes on one instance are summed (merge_peers),
// the lowest adds the sums into the block's partial sums in shared memory
// after the other variants', and the block adds them into an f32 [I, 10]
// accumulator once at its end.
//
// Where the derivative has a kink, the kernels take vrt's side (JAX's; the
// plain stages take it through core/kinks.py):
//   max(x, c) / min(x, c) / clip(x, lo, hi): x's cotangent whole where x is
//     strictly inside, half at a tie with the bound (clip is a max, then a
//     min), none outside, and a NaN passes none (pass_max, pass_min,
//     pass_clip);
//   abs: 1 where x >= 0 (at 0 and at -0 too), else -1 (dabs);
//   where: only the selected branch gets the gradient;
//   _safe_unit / _safe_div / the normalisations: zero where the length is 0;
//   pow(x, 5): 5 x^4, so 0 at 0;
//   spot_light_intensity's where(inside, ...): nothing flows outside the
//     cone but the light direction's own gradient.
// A miss lane's record is read by no one (the combine stage selects the env
// there, and the traces the level spawns march it with t_max = -inf): both
// kernels branch on the hit flag, never multiply by it, and write exact zeros
// into every cotangent of a lane that has none, whatever its record holds.

// Sums v over the lanes of `mask` (the lanes that call it together) that
// hold the same key (a segmented tree reduction: log2 of the largest
// group's size rounds of N shuffles), into the group's lowest lane, which
// is returned.  Lanes whose keys are all distinct skip the rounds.
template <int N>
__device__ __forceinline__ int merge_peers_in(unsigned mask, long long key,
                                              float (&v)[N], int lane) {
  const unsigned peers = __match_any_sync(mask, key);
  unsigned above = peers & (0xfffffffeu << lane);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(mask, above != 0u)) {
    const int next = __ffs(above);              // 1 + the next peer's lane
    for (int e = 0; e < N; ++e) {
      const float o = __shfl_sync(mask, v[e], next > 0 ? next - 1 : lane);
      if (next > 0) v[e] += o;
    }
    // a peer at an odd rank has handed its sum down: drop it
    above &= ~__ballot_sync(mask, rank & 1u);
    rank >>= 1;
  }
  return __ffs(peers) - 1;
}

// merge_peers_in over the whole warp: every lane of the warp calls it.
template <int N>
__device__ __forceinline__ int merge_peers(long long key, float (&v)[N],
                                           int lane) {
  return merge_peers_in(kFullWarp, key, v, lane);
}

// Where a texture or env variant adds a sampled table's cotangents: the
// block's partial sums in shared memory (`sh`, added into the table once at
// the block's end), or, where the table does not fit (`sh` null), the
// table's f32 accumulator itself.
struct TableSink {
  float* sh;
  float* global;
};

// The probe's switches of the texture and env variants' table sums
// (vrt_torch.apps.probe_caps tex_env), in both designs: 0 as designed; 1 the
// taps computed but nothing added (no merge, no atomic, no flush); 2 each
// lane's own atomics, no merge; 3 the merges and atomics, but no block's
// partial sums flushed into the table; 4 the merges, no atomic; 5 the
// taps' keys and values alone, no merge.  (4 and 5 keep what they skip
// alive by a test that no value meets: kept().)  Every mode gives the
// per-ray cotangents; only 0 gives the tables.
constexpr int kTapSink = 0;

// The probe's modes 4 and 5: true for no finite value the kernels compute,
// so that the skipped sums stay computed.
__device__ __forceinline__ bool kept(float x) { return x == -1.25e-38f; }
// The probe's census (true in its build alone): every merge of texture or
// env taps counts, by the number of distinct keys among the lanes that add
// there, into g_tap_census (vrt_shade_tap_census reads it).
constexpr bool kTapCensus = false;
__device__ unsigned long long g_tap_census[33];

// The census of one merge: `key` among the lanes of `mask` that add (`on`).
__device__ __forceinline__ void tap_census(unsigned mask, bool on,
                                           long long key, int lane) {
  const unsigned ons = __ballot_sync(mask, on);
  const unsigned peers = __match_any_sync(mask, on ? key : -1ll - lane);
  const unsigned leads = __ballot_sync(mask, on && __ffs(peers) - 1 == lane);
  if (ons != 0u && lane == __ffs(ons) - 1)
    atomicAdd(&g_tap_census[__popc(leads)], 1ull);
}

// One tap's cotangents (g, 3 floats) of the texel `texel` (its row in the
// table viewed as [rows, 3]) into the sink: the lanes of the warp that make
// this call together (divergent code: the lanes active here) and name one
// texel summed first, the group's lowest lane adding each nonzero sum with
// one f32 atomic.  (The first design of the texture and env variants; the
// redesign sums a sample's four taps over the warp at once: warp_taps_add.)
__device__ __forceinline__ void add_texel(const TableSink& sink,
                                          long long texel, float g0,
                                          float g1, float g2) {
  const int lane = threadIdx.x & 31;
  float v[3] = {g0, g1, g2};
  if (kTapCensus) tap_census(__activemask(), true, texel, lane);
  if (kTapSink == 1) return;
  if (kTapSink == 5) {
    if (kept(g0 + g1 + g2 + static_cast<float>(texel)))
      atomicAdd(sink.global, g0);
    return;
  }
  if (kTapSink == 2) {
    float* dst = (sink.sh != nullptr ? sink.sh : sink.global) + 3 * texel;
    for (int c = 0; c < 3; ++c)
      if (v[c] != 0.0f) atomicAdd(dst + c, v[c]);
    return;
  }
  if (merge_peers_in(__activemask(), texel, v, lane) == lane) {
    float* dst = (sink.sh != nullptr ? sink.sh : sink.global) + 3 * texel;
    if (kTapSink == 4) {
      if (kept(v[0] + v[1] + v[2])) atomicAdd(dst, v[0]);
      return;
    }
    for (int c = 0; c < 3; ++c)
      if (v[c] != 0.0f) atomicAdd(dst + c, v[c]);
  }
}

// The cotangents of a bilinear sample's four taps (00, 10, 01, 11 at the
// texels t00 ... t11) for the sample's cotangent g, in autograd's order of
// the lerps (top * (1 - fv) + bot * fv, top = c00 * (1 - fu) + c10 * fu),
// into the sink.  Taps that fall on one texel (a wrap or a clamp) add.  A
// lane whose g is zero (the env lookup of a bounce lane whose mirror term
// is off: most lanes of a deeper level) adds nothing and skips the merges.
__device__ __forceinline__ void add_taps(const TableSink& sink,
                                         const float g[3], float fu, float fv,
                                         long long t00, long long t10,
                                         long long t01, long long t11) {
  if (g[0] == 0.0f && g[1] == 0.0f && g[2] == 0.0f) return;
  float top[3], bot[3];
  for (int c = 0; c < 3; ++c) {
    top[c] = g[c] * (1.0f - fv);
    bot[c] = g[c] * fv;
  }
  const float gu = 1.0f - fu;
  add_texel(sink, t00, top[0] * gu, top[1] * gu, top[2] * gu);
  add_texel(sink, t10, top[0] * fu, top[1] * fu, top[2] * fu);
  add_texel(sink, t01, bot[0] * gu, bot[1] * gu, bot[2] * gu);
  add_texel(sink, t11, bot[0] * fu, bot[1] * fu, bot[2] * fu);
}

// A block's partial sums of `words` floats (the material variant's, the
// texture and env variants' on the shared path) into the table's
// accumulator, one f32 atomic a nonzero word.  Every thread of the block
// calls it, after a __syncthreads.
__device__ __forceinline__ void flush_table(float* global, const float* sh,
                                            long long words) {
  for (long long w = threadIdx.x; w < words; w += blockDim.x)
    if (sh[w] != 0.0f) atomicAdd(global + w, sh[w]);
}

// ---- the texture and env variants' taps, the redesign ------------------------
//
// What held the first design back (chip_smoke.py, vrt_torch.apps.probe_caps
// tex_env; ncu cannot run on the card's machine): its 36 taps a lit hit lane
// and 4 a miss lane, each a merge of its own (add_texel: a match on a
// 64-bit key, then rounds of shuffles, an any and a ballot) inside the lane's
// divergent code, where the texture variant spilled at its 80-register cap
// and the env variant at 128.  Its tables add no bytes to speak of (9 KB and
// 4.6 KB): the time went to those instructions.  The redesign sums the four
// taps of one bilinear sample under one key, the sample's footprint (its
// texel t00, which names the other three), over the whole warp at a point
// where every lane of it runs (warp_taps_add): where every lane that adds
// shares the footprint (a miss warp under an env texel that spans hundreds
// of pixels) one transposed butterfly of 16 shuffles sums the 12 floats and
// 12 lanes add one each; elsewhere a segmented merge of the 12 floats, one
// round of 12 shuffles a halving of the largest group.  The texture variant
// stages what its taps need (the object position, the blend weights and the
// three samples' cotangents: 16 words a lane in shared memory) from the hit
// lanes' code and sums the 9 samples after it, over the whole warp
// (stage_taps_reduce); the env variant sums an all-miss warp's taps right
// after its lookup and a hit warp's miss lanes after the warp's lit code
// (env_taps_warp).  Each lane's taps are the first design's products, bit
// for bit; only the order of the sums differs.  Measured and dropped (the
// probe's builds, PERF.md): a copy of the partial sums a warp (no gain: the
// warps of a block barely contend), each lane's sums carried in place while
// a warp keeps one env footprint (a warp's next round lies elsewhere in the
// frame, and runs of adjacent rounds unbalanced the warps), the compare-and-
// swap of a lane's 12 sums at once, and one lane adding its own.

// merge_peers_in over a 32-bit key.
template <int N>
__device__ __forceinline__ int merge_peers32(unsigned mask, int key,
                                             float (&v)[N], int lane) {
  const unsigned peers = __match_any_sync(mask, key);
  unsigned above = peers & (0xfffffffeu << lane);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(mask, above != 0u)) {
    const int next = __ffs(above);
    for (int e = 0; e < N; ++e) {
      const float o = __shfl_sync(mask, v[e], next > 0 ? next - 1 : lane);
      if (next > 0) v[e] += o;
    }
    above &= ~__ballot_sync(mask, rank & 1u);
    rank >>= 1;
  }
  return __ffs(peers) - 1;
}

// One step of a transposed butterfly over the lanes `off` apart: a lane
// keeps the half of a[0..2H-1] its lane bit `off` names and adds its
// partner's copy of that half, into a[0..H-1] (H shuffles).
template <int H>
__device__ __forceinline__ void warp_halve(float* a, int lane, int off) {
  const bool up = lane & off;
#pragma unroll
  for (int j = 0; j < H; ++j)
    a[j] = (up ? a[j + H] : a[j]) +
           __shfl_xor_sync(kFullWarp, up ? a[j] : a[j + H], off);
}

// The sums over the 32 lanes of a converged warp of v[0..N-1] (N <= 32,
// padded with zeros to W = 32, 16 or 8 words: a transposed butterfly, each
// step a lane keeping half of what it holds, 16 + 8 + 4 + 2 + 1 shuffles
// for W = 32, 8 + 4 + 2 + 1 + 1 for W = 16, 4 + 2 + 1 + 1 + 1 for W = 8): a
// lane returns the sum of v[warp_word<N>(lane)] (zero where that is N or
// more): lane e holds word e for W = 32, lanes 2e and 2e + 1 for W = 16,
// lanes 4e ... 4e + 3 for W = 8.
template <int N>
__device__ __forceinline__ float warp_sum(const float (&v)[N], int lane) {
  static_assert(N <= 32, "warp_sum sums up to 32 words");
  float a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = j < N ? v[j] : 0.0f;
  if constexpr (N > 16) {
    warp_halve<16>(a, lane, 16);
    warp_halve<8>(a, lane, 8);
    warp_halve<4>(a, lane, 4);
    warp_halve<2>(a, lane, 2);
    warp_halve<1>(a, lane, 1);
    return a[0];
  } else if constexpr (N > 8) {
    warp_halve<8>(a, lane, 16);
    warp_halve<4>(a, lane, 8);
    warp_halve<2>(a, lane, 4);
    warp_halve<1>(a, lane, 2);
    return a[0] + __shfl_xor_sync(kFullWarp, a[0], 1);
  } else {
    warp_halve<4>(a, lane, 16);
    warp_halve<2>(a, lane, 8);
    warp_halve<1>(a, lane, 4);
    a[0] += __shfl_xor_sync(kFullWarp, a[0], 2);
    return a[0] + __shfl_xor_sync(kFullWarp, a[0], 1);
  }
}

// The word whose sum warp_sum<N> returns to `lane`.
template <int N>
__device__ __forceinline__ int warp_word(int lane) {
  return N > 16 ? lane : N > 8 ? lane >> 1 : lane >> 2;
}

// Whether `lane` is the lowest of the lanes warp_sum<N> returns its word
// to.
template <int N>
__device__ __forceinline__ bool warp_word_lead(int lane) {
  return (lane & (N > 16 ? 0 : N > 8 ? 1 : 3)) == 0;
}

// One sum x of a tap's channel c at texel `texel` into the table (one f32
// atomic where x is nonzero; the probe's kTapSink 4 adds nothing).
__device__ __forceinline__ void tap_add(float* table, int texel, int c,
                                        float x) {
  if (kTapSink == 4) {
    if (kept(x)) atomicAdd(table, x);
  } else if (x != 0.0f) {
    atomicAdd(table + 3 * texel + c, x);
  }
}

// One bilinear sample's four taps (texels tex[0..3]: 00, 10, 01, 11; their
// cotangents v, 3 floats a tap) from every lane of a converged warp that
// adds (`on`; the others hold zeros), summed under the sample's footprint
// `key` (equal keys name equal texels), into the sink: where every such
// lane shares the key, one butterfly; else a segmented merge, the group's
// lowest lane adding its 12 sums.  One f32 atomic a nonzero sum.
__device__ __forceinline__ void warp_taps_add(const TableSink& sink, bool on,
                                              int key, const int (&tex)[4],
                                              const float (&v)[12],
                                              int lane) {
  if (kTapSink == 5) {
    float f = static_cast<float>(key + tex[1] + tex[2] + tex[3]);
    for (int e = 0; e < 12; ++e) f += v[e];
    if (kept(f)) atomicAdd(sink.global, f);
    return;
  }
  const unsigned ons = __ballot_sync(kFullWarp, on);
  if (ons == 0u) return;
  if (kTapCensus) tap_census(kFullWarp, on, key, lane);
  if (kTapSink == 1) return;
  float* const table = sink.sh != nullptr ? sink.sh : sink.global;
  if (kTapSink == 2) {
    // the probe's mode 2: each lane's own atomics
    if (on)
#pragma unroll
      for (int e = 0; e < 12; ++e) tap_add(table, tex[e / 3], e % 3, v[e]);
    return;
  }
  const int lead = __ffs(ons) - 1;
  // every lane takes part in the shuffle (a full-warp sync)
  const int lead_key = __shfl_sync(kFullWarp, key, lead);
  if (__all_sync(kFullWarp, !on || key == lead_key)) {
    const float s = warp_sum(v, lane);
    const int e = warp_word<12>(lane);
    const int t0 = __shfl_sync(kFullWarp, tex[0], lead);
    const int t1 = __shfl_sync(kFullWarp, tex[1], lead);
    const int t2 = __shfl_sync(kFullWarp, tex[2], lead);
    const int t3 = __shfl_sync(kFullWarp, tex[3], lead);
    if (!(lane & 1) && e < 12)
      tap_add(table, e < 3 ? t0 : (e < 6 ? t1 : (e < 9 ? t2 : t3)),
              e - 3 * (e / 3), s);
    return;
  }
  float w[12];
  for (int e = 0; e < 12; ++e) w[e] = v[e];
  if (merge_peers32(kFullWarp, on ? key : -1 - lane, w, lane) == lane && on)
#pragma unroll
    for (int e = 0; e < 12; ++e) tap_add(table, tex[e / 3], e % 3, w[e]);
}

// The twelve cotangents of a bilinear sample's taps for the sample's
// cotangent g, each the first design's product (add_taps), into v.
__device__ __forceinline__ void tap_values(const float g[3], float fu,
                                           float fv, float (&v)[12]) {
  float top[3], bot[3];
  for (int c = 0; c < 3; ++c) {
    top[c] = g[c] * (1.0f - fv);
    bot[c] = g[c] * fv;
  }
  const float gu = 1.0f - fu;
  for (int c = 0; c < 3; ++c) {
    v[c] = top[c] * gu;
    v[3 + c] = top[c] * fu;
    v[6 + c] = bot[c] * gu;
    v[9 + c] = bot[c] * fu;
  }
}

__device__ __forceinline__ float dabs(float x) {   // d|x|/dx, jnp.abs'
  return x >= 0.0f ? 1.0f : -1.0f;
}

// The cotangent g of max(x, c), min(x, c) or clip(x, lo, hi) that reaches x.
__device__ __forceinline__ float pass_max(float x, float c, float g) {
  return x > c ? g : (x == c ? 0.5f * g : 0.0f);
}
__device__ __forceinline__ float pass_min(float x, float c, float g) {
  return x < c ? g : (x == c ? 0.5f * g : 0.0f);
}
__device__ __forceinline__ float pass_clip(float x, float lo, float hi,
                                           float g) {
  return pass_max(x, lo, pass_min(nmax(x, lo), hi, g));
}

// y = v / |v| where |v|^2 > 0, else 0 (renderer.py _safe_unit, the half
// vector of brdf.py, the tangent normal): the cotangent of v for that of y.
__device__ __forceinline__ void safe_unit_bwd(const float v[3],
                                              const float gy[3],
                                              float gv[3]) {
  const float n2 = dot3(v, v);
  if (!(n2 > 0.0f)) {
    gv[0] = gv[1] = gv[2] = 0.0f;
    return;
  }
  const float norm = sqrtf(n2);
  const float s = dot3(gy, v) / ((norm * norm) * norm);
  for (int c = 0; c < 3; ++c) gv[c] = gy[c] / norm - v[c] * s;
}

// The transpose of rotate(qv, qw, .) (a linear map of v, exactly
// I + 2 qw [qv]x + 2 [qv]x^2 whatever |q|) is rotate(qv, -qw, .).
__device__ __forceinline__ void rotate_t(const float qv[3], float qw,
                                         const float g[3], float out[3]) {
  rotate(qv, -qw, g, out);
}

// The reverse of add_radiance for the cotangent go of its output: adds the
// cotangents of li, wi, wo, n, albedo, roughness and metallic and, with
// kGradK (the light variant's), of the geometry term's k.
template <bool kGradK>
__device__ __forceinline__ void radiance_bwd_impl(
    const float li[3], const float wi[3], const float wo[3], const float n[3],
    const float albedo[3], float r, float m, float k, const float go[3],
    float g_li[3], float g_wi[3], float g_wo[3], float g_n[3],
    float g_albedo[3], float& g_r, float& g_m, float& g_k) {
  float hr[3], h[3];
  for (int c = 0; c < 3; ++c) hr[c] = wi[c] + wo[c];
  const float hn2 = dot3(hr, hr);
  const float hnorm = sqrtf(hn2 > 0.0f ? hn2 : 1.0f);
  for (int c = 0; c < 3; ++c) h[c] = hn2 > 0.0f ? hr[c] / hnorm : 0.0f;
  const float a2 = r * r;
  const float nh = dot3(n, h);
  const float ndoth = nmax(nh, 0.0f);
  const float cc = (ndoth * ndoth) * (a2 - 1.0f) + 1.0f;
  const float dd_raw = (kPi * cc) * cc;
  const float dd = nmax(dd_raw, 0.001f);
  const float dist = a2 / dd;
  const float wh = dot3(wo, h);
  const float x = 1.0f - nmax(wh, 0.0f);
  const float xc = nmax(x, 0.0f);
  const float pw = powf(xc, 5.0f);
  const float nwo = dot3(n, wo), nwi = dot3(n, wi);
  const float dwo = nmax(nwo, 0.0f), dwi = nmax(nwi, 0.0f);
  const float deno = dwo * (1.0f - k) + k, deni = dwi * (1.0f - k) + k;
  const float gso = dwo / deno, gsi = dwi / deni;
  const float g = gso * gsi;
  const float dr = (4.0f * dwo) * dwi;
  const float denom = nmax(dr, 0.0001f);
  const float spec = (dist * g) / denom;
  const float diel = 1.0f - m;

  float g_spec = 0.0f, g_pw = 0.0f, g_nwi = 0.0f, g_diel = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float f0 = kF0Diel * diel + albedo[c] * m;
    const float f = f0 + (1.0f - f0) * pw;
    const float lambert = albedo[c] / kPi;
    const float kd = (1.0f - f) * diel;
    const float brdf = lambert * kd + (spec * f) * f;
    const float g_brdf = (go[c] * li[c]) * nwi;
    g_li[c] += (go[c] * brdf) * nwi;
    g_nwi += (go[c] * brdf) * li[c];
    const float g_cook = g_brdf * f;
    float g_f = g_brdf * (spec * f) + g_cook * spec - (g_brdf * lambert) * diel;
    g_spec += g_cook * f;
    g_diel += (g_brdf * lambert) * (1.0f - f);
    g_albedo[c] += (g_brdf * kd) / kPi;
    const float g_f0 = g_f * (1.0f - pw);
    g_pw += g_f * (1.0f - f0);
    g_diel += g_f0 * kF0Diel;
    g_albedo[c] += g_f0 * m;
    g_m += g_f0 * albedo[c];
  }
  g_m -= g_diel;
  // spec = (dist * g) / denom
  const float g_dist = (g_spec * g) / denom;
  const float g_g = (g_spec * dist) / denom;
  const float g_dr = pass_max(dr, 0.0001f, -(g_spec * spec) / denom);
  float g_dwo = g_dr * (4.0f * dwi) + (g_g * gsi) * (k / (deno * deno));
  float g_dwi = g_dr * (4.0f * dwo) + (g_g * gso) * (k / (deni * deni));
  if (kGradK) {
    // brdf.py g_schlick: d/dk of w / (w (1 - k) + k) is -(w / den) (1 - w)
    // / den
    g_k += (g_g * gsi) * (-(gso * (1.0f - dwo)) / deno) +
           (g_g * gso) * (-(gsi * (1.0f - dwi)) / deni);
  }
  const float g_nwo = pass_max(nwo, 0.0f, g_dwo);
  g_nwi += pass_max(nwi, 0.0f, g_dwi);
  // pw = max(1 - max(wh, 0), 0)^5
  const float g_x = pass_max(x, 0.0f, (g_pw * 5.0f) * powf(xc, 4.0f));
  const float g_wh = pass_max(wh, 0.0f, -g_x);
  // dist = a2 / max(pi cc^2, 1e-3)
  float g_a2 = g_dist / dd;
  const float g_dd = pass_max(dd_raw, 0.001f, -(g_dist * dist) / dd);
  const float g_cc = g_dd * (2.0f * (kPi * cc));
  const float g_nh = pass_max(nh, 0.0f, g_cc * (2.0f * ndoth * (a2 - 1.0f)));
  g_a2 += g_cc * (ndoth * ndoth);
  g_r += g_a2 * (2.0f * r);
  float g_h[3];
  for (int c = 0; c < 3; ++c) {
    g_n[c] += (g_nh * h[c] + g_nwo * wo[c]) + g_nwi * wi[c];
    g_h[c] = g_nh * n[c] + g_wh * wo[c];
    g_wo[c] += g_wh * h[c] + g_nwo * n[c];
    g_wi[c] += g_nwi * n[c];
  }
  float g_hr[3];
  safe_unit_bwd(hr, g_h, g_hr);
  for (int c = 0; c < 3; ++c) {
    g_wi[c] += g_hr[c];
    g_wo[c] += g_hr[c];
  }
}

// radiance_bwd_impl without k's cotangent (every default launch) and with
// it (the light variant).
__device__ void radiance_bwd(const float li[3], const float wi[3],
                             const float wo[3], const float n[3],
                             const float albedo[3], float r, float m, float k,
                             const float go[3], float g_li[3], float g_wi[3],
                             float g_wo[3], float g_n[3], float g_albedo[3],
                             float& g_r, float& g_m) {
  float unused = 0.0f;
  radiance_bwd_impl<false>(li, wi, wo, n, albedo, r, m, k, go, g_li, g_wi,
                           g_wo, g_n, g_albedo, g_r, g_m, unused);
}

__device__ void radiance_bwd_k(const float li[3], const float wi[3],
                               const float wo[3], const float n[3],
                               const float albedo[3], float r, float m,
                               float k, const float go[3], float g_li[3],
                               float g_wi[3], float g_wo[3], float g_n[3],
                               float g_albedo[3], float& g_r, float& g_m,
                               float& g_k) {
  radiance_bwd_impl<true>(li, wi, wo, n, albedo, r, m, k, go, g_li, g_wi,
                          g_wo, g_n, g_albedo, g_r, g_m, g_k);
}

// The reverse of light_at: the shadow origin's cotangent (added) for those
// of the direction to the light and of its intensity and, with kRow (the
// light variant's), those of the light's staged row (added into g_row, by
// word: position, intensity, att_l, att_e and, for a spot light, its
// forward direction and cone; the colour's are the caller's).
template <bool kRow>
__device__ __forceinline__ void light_at_bwd_impl(const float* row, bool spot,
                                                  const float so[3],
                                                  const float g_sdir[3],
                                                  float g_inten,
                                                  float g_so[3],
                                                  float* g_row) {
  float delta[3];
  for (int c = 0; c < 3; ++c) delta[c] = row[c] - so[c];
  const float dist = sqrtf(dot3(delta, delta));
  float g_dist = 0.0f;
  const float att_l = row[spot ? 7 : 4], att_e = row[spot ? 8 : 5];
  const float den = (1.0f + att_l * dist) + (att_e * dist) * dist;
  const float g_den_per = att_l + 2.0f * (att_e * dist);
  if (!spot) {
    const float inten = row[3] / den;
    g_dist += -(g_inten * inten / den) * g_den_per;
    if (kRow) {
      const float g_den = -(g_inten * inten / den);
      g_row[3] += g_inten / den;
      g_row[4] += g_den * dist;
      g_row[5] += (g_den * dist) * dist;
    }
  } else {
    float to[3];
    for (int c = 0; c < 3; ++c) to[c] = so[c] - row[c];
    const float norm = sqrtf(dot3(to, to));
    float tn[3];
    for (int c = 0; c < 3; ++c) tn[c] = to[c] / norm;
    const float cs = dot3(row + 3, tn);
    const float cos_angle = row[9], cos_falloff = row[10];
    if (cs >= 0.0f && cs > cos_angle) {
      const float q = (cs - cos_angle) / (cos_falloff - cos_angle);
      const float i1 = row[6] * nmin(q, 1.0f);
      const float g_i1 = g_inten / den;
      g_dist += -(g_inten * (i1 / den) / den) * g_den_per;
      const float g_q = pass_min(q, 1.0f, g_i1 * row[6]);
      const float g_cs = g_q / (cos_falloff - cos_angle);
      float g_tn[3], g_to[3];
      for (int c = 0; c < 3; ++c) g_tn[c] = row[3 + c] * g_cs;
      const float s = dot3(g_tn, to) / ((norm * norm) * norm);
      for (int c = 0; c < 3; ++c) g_to[c] = g_tn[c] / norm - to[c] * s;
      if (norm != 0.0f)
        for (int c = 0; c < 3; ++c) g_so[c] += g_to[c];
      if (kRow) {
        // to = so - pos; cs = fwd . to / |to|; q = (cs - ca) / (cf - ca);
        // inten = pos_intensity min(q, 1) / den
        const float g_den = -(g_inten * (i1 / den) / den);
        if (norm != 0.0f)
          for (int c = 0; c < 3; ++c) g_row[c] -= g_to[c];
        for (int c = 0; c < 3; ++c) g_row[3 + c] += g_cs * tn[c];
        g_row[6] += g_i1 * nmin(q, 1.0f);
        g_row[7] += g_den * dist;
        g_row[8] += (g_den * dist) * dist;
        g_row[9] += g_q * (q - 1.0f) / (cos_falloff - cos_angle);
        g_row[10] += -(g_q * q) / (cos_falloff - cos_angle);
      }
    }
  }
  if (dist != 0.0f) {
    // sdir = delta / dist, dist = |delta|; delta = row - so
    g_dist += -dot3(g_sdir, delta) / (dist * dist);
    for (int c = 0; c < 3; ++c) {
      const float g_delta = g_sdir[c] / dist + delta[c] * (g_dist / dist);
      g_so[c] -= g_delta;
      if (kRow) g_row[c] += g_delta;
    }
  }
}

__device__ void light_at_bwd(const float* row, bool spot, const float so[3],
                             const float g_sdir[3], float g_inten,
                             float g_so[3]) {
  light_at_bwd_impl<false>(row, spot, so, g_sdir, g_inten, g_so, nullptr);
}

// The reverse of sample_env: the direction's cotangent (added) for that of
// the sample.  The face, the texels and the floors are piecewise constant.
// kEnv (the env variant) also adds the four taps' cotangents into `sink`
// (the env cube viewed as [6 E E, 3]; at a seam the clamped taps fall on
// one texel and add).
template <bool kEnv = false>
__device__ void sample_env_bwd(const float* env, int e, const float d_w[3],
                               const float g[3], float g_d[3],
                               const TableSink* sink = nullptr) {
  const float x = d_w[0], y = d_w[2], z = d_w[1];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool x_major = ax >= ay && ax >= az;
  const bool y_major = !x_major && ay >= az;
  float ma, sc, tc;
  int face;
  // d(ma, sc, tc) / d(x, y, z), as rows
  float dma[3] = {0.0f, 0.0f, 0.0f}, dsc[3] = {0.0f, 0.0f, 0.0f},
        dtc[3] = {0.0f, 0.0f, 0.0f};
  if (x_major) {
    ma = ax;
    dma[0] = dabs(x);
    face = x >= 0.0f ? 0 : 1;
    sc = x >= 0.0f ? -z : z;
    dsc[2] = x >= 0.0f ? -1.0f : 1.0f;
    tc = -y;
    dtc[1] = -1.0f;
  } else if (y_major) {
    ma = ay;
    dma[1] = dabs(y);
    face = y >= 0.0f ? 2 : 3;
    sc = x;
    dsc[0] = 1.0f;
    tc = y >= 0.0f ? z : -z;
    dtc[2] = y >= 0.0f ? 1.0f : -1.0f;
  } else {
    ma = az;
    dma[2] = dabs(z);
    face = z >= 0.0f ? 4 : 5;
    sc = z >= 0.0f ? x : -x;
    dsc[0] = z >= 0.0f ? 1.0f : -1.0f;
    tc = -y;
    dtc[1] = -1.0f;
  }
  const float fe = static_cast<float>(e);
  const float su = sc / ma, sv = tc / ma;
  const float u = ((su + 1.0f) * 0.5f) * fe - 0.5f;
  const float v = ((sv + 1.0f) * 0.5f) * fe - 0.5f;
  const float u0 = floorf(u), v0 = floorf(v);
  const float fu = u - u0, fv = v - v0;
  const int ua = min(max(static_cast<int>(u0), 0), e - 1);
  const int ub = min(max(static_cast<int>(u0 + 1.0f), 0), e - 1);
  const int va = min(max(static_cast<int>(v0), 0), e - 1);
  const int vb = min(max(static_cast<int>(v0 + 1.0f), 0), e - 1);
  const float* base = env + static_cast<long long>(face) * e * e * 3;
  const float* c00 = base + (va * e + ua) * 3;
  const float* c10 = base + (va * e + ub) * 3;
  const float* c01 = base + (vb * e + ua) * 3;
  const float* c11 = base + (vb * e + ub) * 3;
  float g_fu = 0.0f, g_fv = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float a00 = __ldg(c00 + c), a10 = __ldg(c10 + c);
    const float a01 = __ldg(c01 + c), a11 = __ldg(c11 + c);
    const float top = a00 * (1.0f - fu) + a10 * fu;
    const float bot = a01 * (1.0f - fu) + a11 * fu;
    g_fu += g[c] * ((a10 - a00) * (1.0f - fv) + (a11 - a01) * fv);
    g_fv += g[c] * (bot - top);
  }
  const float g_su = g_fu * (0.5f * fe), g_sv = g_fv * (0.5f * fe);
  const float g_sc = g_su / ma, g_tc = g_sv / ma;
  const float g_ma = -(g_su * su + g_sv * sv) / ma;
  // (x, y, z) = (d0, d2, d1)
  const int axis[3] = {0, 2, 1};
  for (int a = 0; a < 3; ++a)
    g_d[axis[a]] += (g_ma * dma[a] + g_sc * dsc[a]) + g_tc * dtc[a];
  if (kEnv) {
    const long long t0 = static_cast<long long>(face) * e * e;
    add_taps(*sink, g, fu, fv, t0 + va * e + ua, t0 + va * e + ub,
             t0 + vb * e + ua, t0 + vb * e + ub);
  }
}

// A lane's env footprint, sample_env's lookup of direction d_w (its face,
// floors and weights line for line): the key (the face and the unclamped
// floors, which name the four clamped texels), those texels (00, 10, 01,
// 11 in the cube viewed as [6 E E, 3]) and the weights fu, fv.
struct EnvFoot {
  int key, tex[4];
  float fu, fv;
};

__device__ __forceinline__ void env_foot(int e, const float d_w[3],
                                         EnvFoot& f) {
  const float x = d_w[0], y = d_w[2], z = d_w[1];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool x_major = ax >= ay && ax >= az;
  const bool y_major = !x_major && ay >= az;
  float ma, sc, tc;
  int face;
  if (x_major) {
    ma = ax;
    face = x >= 0.0f ? 0 : 1;
    sc = x >= 0.0f ? -z : z;
    tc = -y;
  } else if (y_major) {
    ma = ay;
    face = y >= 0.0f ? 2 : 3;
    sc = x;
    tc = y >= 0.0f ? z : -z;
  } else {
    ma = az;
    face = z >= 0.0f ? 4 : 5;
    sc = z >= 0.0f ? x : -x;
    tc = -y;
  }
  const float fe = static_cast<float>(e);
  const float u = ((sc / ma + 1.0f) * 0.5f) * fe - 0.5f;
  const float v = ((tc / ma + 1.0f) * 0.5f) * fe - 0.5f;
  const float u0 = floorf(u), v0 = floorf(v);
  const int iu = static_cast<int>(u0), iv = static_cast<int>(v0);
  const int ua = min(max(iu, 0), e - 1);
  const int ub = min(max(static_cast<int>(u0 + 1.0f), 0), e - 1);
  const int va = min(max(iv, 0), e - 1);
  const int vb = min(max(static_cast<int>(v0 + 1.0f), 0), e - 1);
  const int t0 = face * e * e;
  f.tex[0] = t0 + va * e + ua;
  f.tex[1] = t0 + va * e + ub;
  f.tex[2] = t0 + vb * e + ua;
  f.tex[3] = t0 + vb * e + ub;
  // the floors lie in [-1, e - 1]
  f.key = (face * (e + 1) + (iv + 1)) * (e + 1) + (iu + 1);
  f.fu = u - u0;
  f.fv = v - v0;
}

// The env redesign's taps of a converged warp (miss lanes, `on`, of
// direction d_w and cotangent g; a lane whose g is zero adds nothing),
// summed over the warp under each lookup's footprint (warp_taps_add).
__device__ __forceinline__ void env_taps_warp(const TableSink& sink, int e,
                                              const float d_w[3],
                                              const float g[3], bool on,
                                              int lane) {
  on = on && !(g[0] == 0.0f && g[1] == 0.0f && g[2] == 0.0f);
  if (!__any_sync(kFullWarp, on)) return;
  EnvFoot f = {-1, {0, 0, 0, 0}, 0.0f, 0.0f};
  float v[12];
  for (int k = 0; k < 12; ++k) v[k] = 0.0f;
  if (on) {
    env_foot(e, d_w, f);
    tap_values(g, f.fu, f.fv, v);
  }
  warp_taps_add(sink, on, f.key, f.tex, v, lane);
}

struct CombineBwdParams {
  CombineParams f;             // the forward's inputs; f.out is not read
  const float* g_rgb;          // [R,3]
  // the cotangents, each [R,3] or [R], null where nobody needs it
  float* g_albedo;
  float* g_shadow_origin;
  float* g_n_w;
  float* g_roughness;
  float* g_metallic;
  float* g_refl_dir;
  float* g_d_w;
  float* g_n_obj;
  float* g_refl_rgb;
  // the light variant's: the record's k [R] (null unlit) and the light
  // tables' accumulator, the 15 tables flattened in the order of Lights
  // (129 floats), added into
  float* g_k;
  float* g_lights;
  // the env variant's: the env cube's accumulator [6,E,E,3] f32, added
  // into; with env_shared a block sums its cotangents in shared memory
  // first
  float* g_env;
  int env_shared;
};

// the largest env cube whose cotangents a block sums in shared memory
// (kernels/shade.py ENV_SHARED_BYTES); a larger one takes f32 atomics into
// its accumulator
constexpr int kEnvSharedBytes = 16 * 1024;

// The light tables flattened one after another at their padded shapes
// (kernels/shade.py light_shapes): where each begins.
constexpr int kGradDir = 0, kGradStrength = 3, kGradPointPos = 4,
              kGradPointI = 19, kGradPointAttL = 24, kGradPointAttE = 29,
              kGradPointColor = 34, kGradSpotPos = 54, kGradSpotFwd = 69,
              kGradSpotI = 84, kGradSpotAttL = 89, kGradSpotAttE = 94,
              kGradSpotCosA = 99, kGradSpotCosF = 104, kGradSpotColor = 109;

// Where word w of the staged lights goes in the flattened tables (-1 for
// a row's padding).
__device__ __forceinline__ int light_grad_index(int w, int points) {
  if (w < 3) return kGradDir + w;
  if (w == 3) return kGradStrength;
  if (w < 4 + points * kPointRow) {
    const int i = (w - 4) / kPointRow, c = (w - 4) % kPointRow;
    if (c < 3) return kGradPointPos + 3 * i + c;
    if (c == 3) return kGradPointI + i;
    if (c == 4) return kGradPointAttL + i;
    if (c == 5) return kGradPointAttE + i;
    if (c < 9) return kGradPointColor + 4 * i + (c - 6);
    return -1;
  }
  const int r = w - 4 - points * kPointRow;
  const int i = r / kSpotRow, c = r % kSpotRow;
  if (c < 3) return kGradSpotPos + 3 * i + c;
  if (c < 6) return kGradSpotFwd + 3 * i + (c - 3);
  if (c == 6) return kGradSpotI + i;
  if (c == 7) return kGradSpotAttL + i;
  if (c == 8) return kGradSpotAttE + i;
  if (c == 9) return kGradSpotCosA + i;
  if (c == 10) return kGradSpotCosF + i;
  if (c < 14) return kGradSpotColor + 4 * i + (c - 11);
  return -1;
}

__device__ __forceinline__ int light_words(const Lights& l) {
  return 4 + l.points * kPointRow + l.spots * kSpotRow;
}

// One word of a light's cotangent into the block's partial sums sh_g: over a
// converged warp (``converged``, the same on every lane) by a shuffle tree,
// then lane 0's one shared atomic; else the lane's own atomic, where it is
// nonzero.
__device__ __forceinline__ void light_grad_add(float* sh_g, int w, float v,
                                               bool converged) {
  if (converged) {
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFullWarp, v, off);
    if ((threadIdx.x & 31) == 0 && v != 0.0f) atomicAdd(sh_g + w, v);
  } else if (v != 0.0f) {
    atomicAdd(sh_g + w, v);
  }
}

// The light variant's block epilogue: the block's partial sums (sh_g, one
// a staged word) into the flattened tables, one f32 atomic a nonzero word.
// Every thread of the block calls it.
__device__ __forceinline__ void flush_light_grads(const CombineBwdParams& q,
                                                  const float* sh_g) {
  __syncthreads();
  const int words = light_words(q.f.lights);
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int to = light_grad_index(w, q.f.lights.points);
    if (to >= 0 && sh_g[w] != 0.0f) atomicAdd(q.g_lights + to, sh_g[w]);
  }
}

// The light variant's partial sums zeroed before the block's first
// __syncthreads.
__device__ __forceinline__ void zero_light_grads(const Lights& l,
                                                 float* sh_g) {
  for (int w = threadIdx.x; w < light_words(l); w += blockDim.x)
    sh_g[w] = 0.0f;
}


template <bool kGrad, bool kEnv = false>
__device__ __forceinline__ void combine_bwd_ray(const CombineBwdParams& q,
                                                const float* sh, long long i,
                                                float* sh_g,
                                                const TableSink* env =
                                                    nullptr);

// kGrad: the light variant, every lane through the redesign's per-lane code
// (combine_bwd_ray), each lane's light cotangents added into the block's
// partial sums on their own; the default keeps the first design's lines.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads) combine_bwd_kernel(
    const CombineBwdParams q) {
  const CombineParams& p = q.f;
  extern __shared__ float sh[];
  if (p.lit) stage_lights(sh, p.lights);
  float* sh_g = sh + light_words(p.lights);
  if (kGrad) zero_light_grads(p.lights, sh_g);
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (kGrad) {
    if (i < p.rays) combine_bwd_ray<true>(q, sh, i, sh_g);
    flush_light_grads(q, sh_g);
    return;
  }
  if (i >= p.rays) return;

  float d_w[3], g[3];
  float g_d[3] = {0.0f, 0.0f, 0.0f}, g_nobj[3] = {0.0f, 0.0f, 0.0f};
  float g_alb[3] = {0.0f, 0.0f, 0.0f}, g_so[3] = {0.0f, 0.0f, 0.0f};
  float g_nw[3] = {0.0f, 0.0f, 0.0f}, g_refl[3] = {0.0f, 0.0f, 0.0f};
  float g_rrgb[3] = {0.0f, 0.0f, 0.0f};
  float g_r = 0.0f, g_m = 0.0f;
  for (int c = 0; c < 3; ++c) {
    d_w[c] = p.d_w[3 * i + c];
    g[c] = q.g_rgb[3 * i + c];
  }

  if (!p.hit[i]) {
    sample_env_bwd(p.env, p.env_side, d_w, g, g_d);
  } else if (p.unlit[i]) {
    for (int c = 0; c < 3; ++c) g_nobj[c] = g[c];
  } else if (!p.lit) {
    for (int c = 0; c < 3; ++c) g_alb[c] = g[c];
  } else {
    float albedo[3], so[3], n_w[3], wo[3], g_wo[3] = {0.0f, 0.0f, 0.0f};
    float g_li[3], g_wi[3];
    for (int c = 0; c < 3; ++c) {
      albedo[c] = p.albedo[3 * i + c];
      so[c] = p.shadow_origin[3 * i + c];
      n_w[c] = p.n_w[3 * i + c];
      wo[c] = -d_w[c];
    }
    const float roughness = p.roughness[i], metallic = p.metallic[i];
    const float k = p.k[i];

    if (p.refl_rgb != nullptr && roughness < 0.3f) {
      float li[3], wi[3], rr[3];
      const float fade = 1.0f - roughness * 2.2f;
      for (int c = 0; c < 3; ++c) {
        rr[c] = p.refl_rgb[3 * i + c];
        li[c] = nmax(rr[c] * fade, 0.0f);
        wi[c] = p.refl_dir[3 * i + c];
        g_li[c] = g_wi[c] = 0.0f;
      }
      radiance_bwd(li, wi, wo, n_w, albedo, roughness, metallic, k, g, g_li,
                   g_wi, g_wo, g_nw, g_alb, g_r, g_m);
      float g_fade = 0.0f;
      for (int c = 0; c < 3; ++c) {
        const float gl = pass_max(rr[c] * fade, 0.0f, g_li[c]);
        g_rrgb[c] = gl * fade;
        g_fade += gl * rr[c];
        g_refl[c] = g_wi[c];
      }
      g_r += g_fade * -2.2f;
    }

    if (!(p.blocked[0] != nullptr && p.blocked[0][i])) {
      // the light's own cotangents are dropped: it is not differentiated
      const float li[3] = {sh[3], sh[3], sh[3]};
      for (int c = 0; c < 3; ++c) g_li[c] = g_wi[c] = 0.0f;
      radiance_bwd(li, sh, wo, n_w, albedo, roughness, metallic, k, g, g_li,
                   g_wi, g_wo, g_nw, g_alb, g_r, g_m);
    }

    const int n_shadow = p.lights.points + p.lights.spots;
    for (int j = 0; j < n_shadow; ++j) {
      const bool spot = j >= p.lights.points;
      const float* row =
          sh + 4 +
          (spot ? p.lights.points * kPointRow +
                      (j - p.lights.points) * kSpotRow
                : j * kPointRow);
      float sdir[3], dist, inten, li[3];
      light_at(row, spot, so, sdir, dist, inten);
      bool lit = inten > (spot ? 0.01f : 0.005f);
      if (p.blocked[1 + j] != nullptr) lit = lit && !p.blocked[1 + j][i];
      if (!lit) continue;
      const float* color = row + (spot ? 11 : 6);
      for (int c = 0; c < 3; ++c) {
        li[c] = color[c] * inten;
        g_li[c] = g_wi[c] = 0.0f;
      }
      radiance_bwd(li, sdir, wo, n_w, albedo, roughness, metallic, k, g, g_li,
                   g_wi, g_wo, g_nw, g_alb, g_r, g_m);
      light_at_bwd(row, spot, so, g_wi, dot3(color, g_li), g_so);
    }
    for (int c = 0; c < 3; ++c) g_d[c] = -g_wo[c];
  }

  store3(q.g_albedo, i, g_alb);
  store3(q.g_shadow_origin, i, g_so);
  store3(q.g_n_w, i, g_nw);
  store1(q.g_roughness, i, g_r);
  store1(q.g_metallic, i, g_m);
  store3(q.g_refl_dir, i, g_refl);
  store3(q.g_d_w, i, g_d);
  store3(q.g_n_obj, i, g_nobj);
  store3(q.g_refl_rgb, i, g_rrgb);
}

// ---- combine backward, the redesign -----------------------------------------
//
// What held the first design (combine_bwd_kernel above) back on the H100
// (chip_smoke.py; ncu cannot run there): one thread a ray over 8,100 blocks
// at 1080p, each block staging the lights anew; every [R,3] input and
// output a lane's own 4-byte words at a stride of 12 B (up to seven [R,3]
// and two [R] cotangents out, about 92 B a lane, most of them zeros); a miss
// lane through the whole epilogue; 119 registers, 16 of an SM's 64 warp
// slots.  Config6's last level (4 hits of 2,073,600 lanes) took 0.0936 ms,
// all miss path and output traffic; at config4's 65,536 rays its 256
// blocks were under one wave of the card and its time one lane's chain of
// radiance_bwd calls.
//
// The redesign (combine_bwd_resident_kernel, the default): resident blocks
// striding over the rays, the lights staged once a block.  On the vector
// path a warp's flags and its [32,3] spans of d_w and g_rgb come by
// cp.async into a ring of kCombineBwdFetchDepth buffers in shared memory,
// rounds ahead of the one it works on, so a round starts with its inputs
// at hand; a warp without a hit runs only the env lookup's backward and
// writes g_d_w through its stage and the other cotangents as 16-byte zero
// spans; a lit lane reads its record's floats, scalars and shadow flags
// at once, and a warp with a hit writes lane by lane.  Measured on the
// card and dropped: the spans loaded one after another through one stage
// (a round trip each: slower than the first design), a hit warp's record
// and cotangents as spans through the stage (slower at config4), no round
// fetched ahead, the first design's grid, blocks of 64 to 224 threads and
// other register caps.  Each lane's arithmetic is the first design's, line
// for line (combine_bwd_lit), so every cotangent it writes is bit-equal to
// the first design's.  The first design keeps its own lines: run through
// the redesign's per-lane code (combine_bwd_ray) on its grid it took 9%
// longer at config6 and 3% less at config4, so it would no longer time
// the design it stands for.  The block, the register cap and the fetch
// depth are the probe's (vrt_torch.apps.probe_caps combine_bwd).

constexpr int kCombineBwdThreads = 256;
constexpr int kCombineBwdWarps = kCombineBwdThreads / 32;
constexpr int kCombineBwdMinBlocks = 2;
// rounds a warp has in its ring: the one it works on and those fetched
// ahead of it (1: none ahead)
constexpr int kCombineBwdFetchDepth = 2;

// What one lane writes: the nine cotangents of combine_bwd_kernel, zero
// unless its branch sets them.
struct CombineGrads {
  float d[3], nobj[3], alb[3], so[3], nw[3], refl[3], rrgb[3];
  float r, m;
};

// What a lit hit lane reads of the record: its floats (refl_rgb and
// refl_dir only where refl_rgb is passed and roughness < 0.3) and, as bit
// j of ``dark``, whether shadow trace j was blocked.
struct CombineRecord {
  float albedo[3], so[3], n_w[3], rr[3], rdir[3];
  float roughness, metallic, k;
  unsigned dark;
};

// The lane's scalars of the record and its shadow traces' flags (the
// directional light's bit 0), read together.
__device__ __forceinline__ void record_scalars(const CombineParams& p,
                                               long long i,
                                               CombineRecord& r) {
  r.roughness = p.roughness[i];
  r.metallic = p.metallic[i];
  r.k = p.k[i];
  r.dark = 0u;
  for (int j = 0; j < 1 + p.lights.points + p.lights.spots; ++j)
    if (p.blocked[j] != nullptr && p.blocked[j][i]) r.dark |= 1u << j;
}

// A lit hit lane's cotangents, the first design's lines, from the record
// the caller read, added into the zeroed ``o``.  kGrad (the light variant)
// also adds the cotangent of the record's k into ``g_k`` and the lights'
// into the block's partial sums ``sh_g`` (light_grad_add); ``converged``
// says every lane of the warp runs it together, ``lane_on`` whether this
// lane is a lit hit (a converged warp's other lanes add zeros and leave
// ``o`` as it is).  The default passes false and true.
template <bool kGrad>
__device__ __forceinline__ void combine_bwd_lit(
    const CombineParams& p, const float* sh, const float d_w[3],
    const float g[3], const CombineRecord& r, CombineGrads& o, float* sh_g,
    float& g_k, bool converged, bool lane_on) {
  float wo[3], g_wo[3] = {0.0f, 0.0f, 0.0f};
  float g_li[3], g_wi[3];
  for (int c = 0; c < 3; ++c) wo[c] = -d_w[c];
  const float* albedo = r.albedo;
  const float* so = r.so;
  const float* n_w = r.n_w;
  const float* rr_in = r.rr;
  const float* rdir = r.rdir;
  const float roughness = r.roughness, metallic = r.metallic, k = r.k;

  if (lane_on && p.refl_rgb != nullptr && roughness < 0.3f) {
    float li[3], wi[3], rr[3];
    const float fade = 1.0f - roughness * 2.2f;
    for (int c = 0; c < 3; ++c) {
      rr[c] = rr_in[c];
      li[c] = nmax(rr[c] * fade, 0.0f);
      wi[c] = rdir[c];
      g_li[c] = g_wi[c] = 0.0f;
    }
    if (kGrad)
      radiance_bwd_k(li, wi, wo, n_w, albedo, roughness, metallic, k, g,
                     g_li, g_wi, g_wo, o.nw, o.alb, o.r, o.m, g_k);
    else
      radiance_bwd(li, wi, wo, n_w, albedo, roughness, metallic, k, g, g_li,
                   g_wi, g_wo, o.nw, o.alb, o.r, o.m);
    float g_fade = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float gl = pass_max(rr[c] * fade, 0.0f, g_li[c]);
      o.rrgb[c] = gl * fade;
      g_fade += gl * rr[c];
      o.refl[c] = g_wi[c];
    }
    o.r += g_fade * -2.2f;
  }

  if (!kGrad) {
    if (!(r.dark & 1u)) {
      // the light's own cotangents are dropped: it is not differentiated
      const float li[3] = {sh[3], sh[3], sh[3]};
      for (int c = 0; c < 3; ++c) g_li[c] = g_wi[c] = 0.0f;
      radiance_bwd(li, sh, wo, n_w, albedo, roughness, metallic, k, g, g_li,
                   g_wi, g_wo, o.nw, o.alb, o.r, o.m);
    }
  } else {
    // the directional light's: its direction's and its strength's
    float gd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (lane_on && !(r.dark & 1u)) {
      const float li[3] = {sh[3], sh[3], sh[3]};
      for (int c = 0; c < 3; ++c) g_li[c] = g_wi[c] = 0.0f;
      radiance_bwd_k(li, sh, wo, n_w, albedo, roughness, metallic, k, g,
                     g_li, g_wi, g_wo, o.nw, o.alb, o.r, o.m, g_k);
      for (int c = 0; c < 3; ++c) gd[c] = g_wi[c];
      gd[3] = (g_li[0] + g_li[1]) + g_li[2];
    }
    for (int w = 0; w < 4; ++w) light_grad_add(sh_g, w, gd[w], converged);
  }

  const int n_shadow = p.lights.points + p.lights.spots;
  for (int j = 0; j < n_shadow; ++j) {
    bool spot;
    const float* row = light_row(sh, p.lights, j, spot);
    float sdir[3], dist, inten, li[3];
    light_at(row, spot, so, sdir, dist, inten);
    const bool lit = inten > (spot ? 0.01f : 0.005f) &&
                     !((r.dark >> (1 + j)) & 1u);
    const float* color = row + (spot ? 11 : 6);
    if (kGrad) {
      // the light's row of cotangents, by staged word
      float gr[kSpotRow];
      for (int w = 0; w < kSpotRow; ++w) gr[w] = 0.0f;
      if (lane_on && lit) {
        for (int c = 0; c < 3; ++c) {
          li[c] = color[c] * inten;
          g_li[c] = g_wi[c] = 0.0f;
        }
        radiance_bwd_k(li, sdir, wo, n_w, albedo, roughness, metallic, k, g,
                       g_li, g_wi, g_wo, o.nw, o.alb, o.r, o.m, g_k);
        light_at_bwd_impl<true>(row, spot, so, g_wi, dot3(color, g_li), o.so,
                                gr);
        for (int c = 0; c < 3; ++c)
          gr[(spot ? 11 : 6) + c] += g_li[c] * inten;
      }
      const int base = static_cast<int>(row - sh);
      for (int w = 0; w < (spot ? 14 : 9); ++w)
        light_grad_add(sh_g, base + w, gr[w], converged);
      continue;
    }
    if (!lit) continue;
    for (int c = 0; c < 3; ++c) {
      li[c] = color[c] * inten;
      g_li[c] = g_wi[c] = 0.0f;
    }
    radiance_bwd(li, sdir, wo, n_w, albedo, roughness, metallic, k, g, g_li,
                 g_wi, g_wo, o.nw, o.alb, o.r, o.m);
    light_at_bwd(row, spot, so, g_wi, dot3(color, g_li), o.so);
  }
  if (lane_on)
    for (int c = 0; c < 3; ++c) o.d[c] = -g_wo[c];
}

// One lane's branch: the env lookup's backward on a miss lane, the
// attribute normal's on an unlit-attribute lane, the albedo's in unlit mode,
// else the lit lane's from the record the caller read.  ``converged`` (the
// light variant's vector path, where every lane of the warp calls it) runs
// the lit lane's code on every lane of the warp, each lane's own where it
// is a lit hit.  kEnv (the env variant) adds a miss lane's env taps into
// `env`.
template <bool kGrad, bool kEnv = false>
__device__ __forceinline__ void combine_bwd_branch(
    const CombineParams& p, const float* sh, bool hit, bool unlit,
    const float d_w[3], const float g[3], const CombineRecord& r,
    CombineGrads& o, float* sh_g, float& g_k, bool converged,
    const TableSink* env = nullptr) {
  if (kGrad && converged) {
    if (!hit) {
      sample_env_bwd<kEnv>(p.env, p.env_side, d_w, g, o.d, env);
    } else if (unlit) {
      for (int c = 0; c < 3; ++c) o.nobj[c] = g[c];
    } else if (!p.lit) {
      for (int c = 0; c < 3; ++c) o.alb[c] = g[c];
    }
    if (p.lit)
      combine_bwd_lit<true>(p, sh, d_w, g, r, o, sh_g, g_k, true,
                            hit && !unlit);
    return;
  }
  if (!hit) {
    sample_env_bwd<kEnv>(p.env, p.env_side, d_w, g, o.d, env);
  } else if (unlit) {
    for (int c = 0; c < 3; ++c) o.nobj[c] = g[c];
  } else if (!p.lit) {
    for (int c = 0; c < 3; ++c) o.alb[c] = g[c];
  } else {
    combine_bwd_lit<kGrad>(p, sh, d_w, g, r, o, sh_g, g_k, false, true);
  }
}

// A lane's nine cotangents, each where asked for, as its own words, and
// the light variant's k.
template <bool kGrad>
__device__ __forceinline__ void combine_bwd_store(const CombineBwdParams& q,
                                                  long long i,
                                                  const CombineGrads& o,
                                                  float g_k) {
  store3(q.g_albedo, i, o.alb);
  store3(q.g_shadow_origin, i, o.so);
  store3(q.g_n_w, i, o.nw);
  store1(q.g_roughness, i, o.r);
  store1(q.g_metallic, i, o.m);
  store3(q.g_refl_dir, i, o.refl);
  store3(q.g_d_w, i, o.d);
  store3(q.g_n_obj, i, o.nobj);
  store3(q.g_refl_rgb, i, o.rrgb);
  if (kGrad) store1(q.g_k, i, g_k);
}

// The scalar path: a lane of a partial warp (or of every warp where a
// tensor is off a 16-byte boundary) on its own words; a miss lane reads its
// direction, its radiance's cotangent and its flag alone.  The light
// variant's sums go into sh_g lane by lane.
template <bool kGrad, bool kEnv>
__device__ __forceinline__ void combine_bwd_ray(const CombineBwdParams& q,
                                                const float* sh, long long i,
                                                float* sh_g,
                                                const TableSink* env) {
  const CombineParams& p = q.f;
  float d_w[3], g[3];
  load3(p.d_w, i, d_w);
  load3(q.g_rgb, i, g);
  CombineGrads o = {};
  float g_k = 0.0f;
  const bool hit = p.hit[i];
  const bool unlit = hit && p.unlit[i];
  CombineRecord r;
  if (hit && !unlit && p.lit) {
    load3(p.albedo, i, r.albedo);
    load3(p.shadow_origin, i, r.so);
    load3(p.n_w, i, r.n_w);
    record_scalars(p, i, r);
    if (p.refl_rgb != nullptr && r.roughness < 0.3f) {
      load3(p.refl_rgb, i, r.rr);
      load3(p.refl_dir, i, r.rdir);
    }
  }
  combine_bwd_branch<kGrad, kEnv>(p, sh, hit, unlit, d_w, g, r, o, sh_g,
                                  g_k, false, env);
  combine_bwd_store<kGrad>(q, i, o, g_k);
}

// What a combine-backward warp fetches ahead on the vector path: its hit and
// unlit flags and its [32,3] spans of d_w and g_rgb.
struct CombineBwdFetch {
  uint8_t flags[2][32];
  float4 d[24];
  float4 g[24];
};

// The fetch of the round whose first ray is w0 (a whole warp in range),
// by cp.async into ``f``; nothing past the rays.
__device__ __forceinline__ void combine_bwd_fetch(const CombineBwdParams& q,
                                                  long long w0, int lane,
                                                  CombineBwdFetch& f) {
  if (w0 + 32 > q.f.rays) return;
  if (lane < 4)
    copy16(f.flags[lane >> 1] + 16 * (lane & 1),
           (lane < 2 ? q.f.hit : q.f.unlit) + w0 + 16 * (lane & 1));
  if (lane < 24) {
    copy16(&f.d[lane], q.f.d_w + 3 * w0 + 4 * lane);
    copy16(&f.g[lane], q.g_rgb + 3 * w0 + 4 * lane);
  }
}

// The vector path: the 32 rays from w0 (a multiple of 32, all in range),
// their flags and inputs in ``f``; ``stage`` holds one span.  A warp
// without a hit writes its cotangents as spans; a warp with a hit reads its
// record and writes its cotangents lane by lane (as spans through the
// stage, measured slower: vrt_torch.apps.probe_caps combine_bwd).  Every
// lane of the warp calls it.  The light variant's warp with a hit runs its
// lit lanes' code on every lane together and sums each light's cotangents
// over the warp by a shuffle tree.  kWarpTaps (the env variant's redesign)
// sums the miss lanes' env taps over the whole warp (env_taps_warp): an
// all-miss warp's right after its lookups, a hit warp's after its lanes'
// code.
template <bool kGrad, bool kEnv = false, bool kWarpTaps = false>
__device__ __forceinline__ void combine_bwd_warp(const CombineBwdParams& q,
                                                 const float* sh,
                                                 const CombineBwdFetch& f,
                                                 float* stage, long long w0,
                                                 int lane, float* sh_g,
                                                 const TableSink* env =
                                                     nullptr) {
  const CombineParams& p = q.f;
  const long long i = w0 + lane;
  const bool hit = f.flags[0][lane] != 0;
  const bool unlit = hit && f.flags[1][lane] != 0;
  const float* fd = reinterpret_cast<const float*>(f.d);
  const float* fg = reinterpret_cast<const float*>(f.g);
  float d_w[3], g[3];
  for (int c = 0; c < 3; ++c) {
    d_w[c] = fd[3 * lane + c];
    g[c] = fg[3 * lane + c];
  }
  CombineGrads o = {};
  float g_k = 0.0f;
  if (!__any_sync(kFullWarp, hit)) {
    // a warp of miss lanes: the env lookup's backward, zeros elsewhere
    sample_env_bwd<kEnv && !kWarpTaps>(p.env, p.env_side, d_w, g, o.d, env);
    if (kEnv && kWarpTaps)
      env_taps_warp(*env, p.env_side, d_w, g, true, lane);
    if (q.g_d_w != nullptr) warp_store3(stage, q.g_d_w, w0, lane, o.d);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    float* const zeroed[6] = {q.g_albedo, q.g_shadow_origin, q.g_n_w,
                              q.g_refl_dir, q.g_n_obj, q.g_refl_rgb};
    for (int j = 0; j < 6; ++j)
      if (zeroed[j] != nullptr && lane < 24)
        reinterpret_cast<uint4*>(zeroed[j] + 3 * w0)[lane] = zero;
    store1(q.g_roughness, i, 0.0f);
    store1(q.g_metallic, i, 0.0f);
    if (kGrad) store1(q.g_k, i, 0.0f);
    return;
  }
  CombineRecord r;
  if (kGrad) r = CombineRecord{};
  if (hit && !unlit && p.lit) {
    load3(p.albedo, i, r.albedo);
    load3(p.shadow_origin, i, r.so);
    load3(p.n_w, i, r.n_w);
    record_scalars(p, i, r);
    if (p.refl_rgb != nullptr && r.roughness < 0.3f) {
      load3(p.refl_rgb, i, r.rr);
      load3(p.refl_dir, i, r.rdir);
    }
  }
  combine_bwd_branch<kGrad, kEnv && !kWarpTaps>(p, sh, hit, unlit, d_w, g,
                                                r, o, sh_g, g_k, true, env);
  combine_bwd_store<kGrad>(q, i, o, g_k);
  // read again from the ring, so the lit lanes' code holds none of them
  if (kEnv && kWarpTaps)
    env_taps_warp(*env, p.env_side, fd + 3 * lane, fg + 3 * lane, !hit,
                  lane);
}

// Resident blocks striding over the rays; kVec takes the vector path for
// every whole warp (the launcher checks the alignment), else the scalar
// path for every lane.  kGrad is the light variant: its blocks keep their
// partial sums of the lights' cotangents in shared memory beside the
// staged lights and add them into the tables once, at the end.  kEnv is the
// env variant: a miss lane's four env taps go into the block's partial sums
// of the env cube after those (env_shared) or into its accumulator, a
// warp's lanes on one texel merged first; with kWarpTaps (the redesign) a
// whole warp's on the vector path at once, a partial warp's (the scalar
// path) as the first design's.  The probe's kTapSink 1 adds nothing (no
// zeroing, no flush), 3 flushes nothing.
template <bool kVec, bool kGrad, bool kEnv, bool kWarpTaps = false>
__device__ __forceinline__ void combine_bwd_resident_body(
    const CombineBwdParams& q) {
  const CombineParams& p = q.f;
  extern __shared__ float sh[];
  __shared__ __align__(16) float stages[kCombineBwdWarps][96];
  __shared__ CombineBwdFetch fetched[kCombineBwdWarps][kCombineBwdFetchDepth];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = stages[warp];
  CombineBwdFetch* buf = fetched[warp];
  float* sh_g = sh + light_words(p.lights);
  const long long stride =
      static_cast<long long>(gridDim.x) * kCombineBwdThreads;
  long long base = static_cast<long long>(blockIdx.x) * kCombineBwdThreads;
  // the first rounds' copies go out before the block stages its lights
  for (int k = 0; k + 1 < kCombineBwdFetchDepth; ++k) {
    if (kVec) combine_bwd_fetch(q, base + k * stride + 32 * warp, lane,
                                buf[k]);
    __pipeline_commit();
  }
  // the env variant's partial sums after the staged lights and the light
  // variant's sums
  float* sh_env = sh + light_words(p.lights) * (kGrad ? 2 : 1);
  const long long env_words = 18ll * p.env_side * p.env_side;
  if (p.lit) stage_lights(sh, p.lights);
  if (kGrad) zero_light_grads(p.lights, sh_g);
  if (kEnv && q.env_shared && kTapSink != 1)
    for (long long w = threadIdx.x; w < env_words; w += blockDim.x)
      sh_env[w] = 0.0f;
  __syncthreads();
  const TableSink env{kEnv && q.env_shared ? sh_env : nullptr, q.g_env};

  for (int round = 0; base < p.rays; base += stride, ++round) {
    // every lane is done with the buffer of the round before: fetch the
    // round kCombineBwdFetchDepth - 1 ahead into it, then wait for this
    // round's copies
    __syncwarp();
    if (kVec)
      combine_bwd_fetch(
          q, base + (kCombineBwdFetchDepth - 1) * stride + 32 * warp, lane,
          buf[(round + kCombineBwdFetchDepth - 1) % kCombineBwdFetchDepth]);
    __pipeline_commit();
    __pipeline_wait_prior(kCombineBwdFetchDepth - 1);
    __syncwarp();
    const long long w0 = base + 32 * warp;
    const long long i = w0 + lane;
    if (kVec && w0 + 32 <= p.rays)
      combine_bwd_warp<kGrad, kEnv, kWarpTaps>(
          q, sh, buf[round % kCombineBwdFetchDepth], stage, w0, lane, sh_g,
          &env);
    else if (i < p.rays)
      combine_bwd_ray<kGrad, kEnv>(q, sh, i, sh_g, &env);
  }
  if (kGrad) flush_light_grads(q, sh_g);
  if (kEnv && q.env_shared && kTapSink != 1 && kTapSink != 3) {
    __syncthreads();
    flush_table(q.g_env, sh_env, env_words);
  }
}

template <bool kVec, bool kGrad>
__global__ void __launch_bounds__(kCombineBwdThreads, kCombineBwdMinBlocks)
    combine_bwd_resident_kernel(const CombineBwdParams q) {
  combine_bwd_resident_body<kVec, kGrad, false>(q);
}

// The env variant of the resident kernel (kGrad as the light variant's):
// instantiated apart, so that the default launches' kernels stay as they
// were.
template <bool kVec, bool kGrad>
__global__ void __launch_bounds__(kCombineBwdThreads, kCombineBwdMinBlocks)
    combine_bwd_env_kernel(const CombineBwdParams q) {
  combine_bwd_resident_body<kVec, kGrad, true>(q);
}

// The env variant's redesign (kGrad as the light variant's): the same body,
// a warp's env taps summed at once (kWarpTaps), the default; the kernel
// above, the first design, stays as its comparator.
template <bool kVec, bool kGrad>
__global__ void __launch_bounds__(kCombineBwdThreads, kCombineBwdMinBlocks)
    combine_bwd_env_warp_kernel(const CombineBwdParams q) {
  combine_bwd_resident_body<kVec, kGrad, true, true>(q);
}

struct SurfaceBwdParams {
  SurfaceParams f;             // the forward's inputs; its outputs unused
  // the record's cotangents, null for zero
  const float* g_albedo;       // [R,3]
  const float* g_shadow_origin;
  const float* g_n_w;
  const float* g_roughness;    // [R]
  const float* g_metallic;
  const float* g_refl_dir;     // [R,3]
  // the inputs' cotangents; g_o_w / g_d_w and g_colors null when not asked
  float* g_o_w;                // [R,3]
  float* g_d_w;
  float* g_t;                  // [R]
  float* g_n_obj;              // [R,3]
  float* g_colors;             // [V*cn^3, 24] or [V*cn^3, 3] f32, added into
  // the material variant's: the record's k cotangent [R] (null for zero)
  // and the material constants' accumulator [V,8] f32 (tint 4, roughness,
  // metallic, k, a word of padding), added into
  const float* g_k;
  float* g_mat;
  // the texture variant's: the accumulators of the texture scale [V,2] and
  // of the stacked textures [T,TH,TW,3], f32, added into; with tex_shared
  // a block sums the textures' cotangents in shared memory first
  float* g_tex_scale;
  float* g_textures;
  int tex_shared;
  // the instance variant's: the accumulator of the instance transforms'
  // cotangents [I, kInstanceWords] f32 (pos, rot, scale), added into
  float* g_inst;
};

constexpr int kMatRow = 8;
// the texture variant's partial sums of the texture scale, a volume
constexpr int kTexScaleRow = 2;
// the largest stacked texture table whose cotangents a block sums in shared
// memory (kernels/shade.py TEXTURE_SHARED_BYTES); a larger one takes f32
// atomics into its accumulator
constexpr int kTexSharedBytes = 32 * 1024;

// The material variant's per-lane cotangents (tint's 3, roughness,
// metallic, k) of volume vol into the block's partial sums sh_mat, one
// shared atomic a nonzero value.
__device__ __forceinline__ void add_material(float* sh_mat, int vol,
                                             const float gm[6]) {
  const int slot[6] = {0, 1, 2, 4, 5, 6};
  for (int e = 0; e < 6; ++e)
    if (gm[e] != 0.0f) atomicAdd(sh_mat + vol * kMatRow + slot[e], gm[e]);
}

// The material variant's block epilogue: the block's partial sums into the
// [V,8] accumulator, one f32 atomic a nonzero word.  Every thread of the
// block calls it.
__device__ __forceinline__ void flush_material(const SurfaceBwdParams& q,
                                               const float* sh_mat) {
  __syncthreads();
  flush_table(q.g_mat, sh_mat, q.f.mat.count * kMatRow);
}

// ---- the material and instance variants' sums, the redesign ----------------
//
// What held the first design back (chip_smoke.py, vrt_torch.apps.probe_caps
// sums): each hit lane carried its table cotangents (the material's 6, the
// instance's 10) in registers through the whole of its code under the
// kernel's 80-register cap, the instance variant's from the normal's
// rotate_bwd to the colour sample's object_bwd while the colour row's 24
// cotangents were live too (ptxas: up to 784 bytes of spills); and after
// it a segmented merge (merge_peers: rounds of N shuffles) and one shared
// f32 atomic a nonzero sum (a compare-and-swap loop on this card), though
// the keys are few and most warps add under one.  The redesign
// (surface_bwd_sums_kernel) takes both out of the lanes' code: a hit lane
// stages the few values its table cotangents follow from (SumWords) in
// shared memory where the stage forms them, an epilogue with little else
// live forms the material's cotangents and the statistics of the
// transform's after the lane's code (sums_epilogue), and the warp sums them
// by one transposed butterfly where every lane that adds shares the key,
// else by a segmented merge, into partial sums of its own in shared memory
// by plain stores (warp_slots_add); the block sums its warps' partial sums
// at its end, forms each instance's transform cotangents from its
// statistics once (inst_from_stats), and adds each nonzero word into the
// accumulator with one f32 atomic.

// The words of the material variant's per-warp partial sums a volume: tint
// 3, roughness, metallic, k (the accumulator's row of kMatRow without its
// tint's fourth word and its padding).
constexpr int kMatSumWords = 6;
// Warps a block of the surface backward.
constexpr int kSumWarps = kThreads / 32;
// The largest dynamic shared memory of the sums redesign (the tables' 48
// KiB, the warps' partial sums and the stage): its attribute, set once.
constexpr int kSumsMaxSharedBytes = 128 * 1024;
// A hit lane's statistics of its instance transform's cotangents: over the
// object-space places the stage reads it at (the textures' hit point and
// the colour sample's origin, points, and its direction) M = sum of a g^T
// (g the place's object-space cotangent, a = (x_w - pos) / scale for a
// point, x_w / scale for the direction) and G = the sum of the points' g;
// at the world normal N = n_shade g_nw^T.  object_bwd and rotate_bwd are
// bilinear in (a, g) and in (n_shade, g_nw) for a given transform, so a
// block's sums of these give its transform cotangents exactly (but for
// rounding).
constexpr int kStatM = 0, kStatG = 9, kStatN = 12, kInstStatWords = 21;

// What the redesign stages of a hit lane (word w of lane l at stage[w *
// kThreads + l]): for the instance variant, the object-space cotangents
// where the stage reads the transform (the world normal: n_shade and n_w's
// cotangent; the textures' hit point: the object position's cotangent; the
// colour sample's ray: the object-space origin's and direction's
// cotangents); for the material variant the texture samples its tint,
// roughness and metallic cotangents need (the albedo's triplanar sample,
// the rm sample's x and y).  What the kernel can read again (o_w, d_w, t,
// the record's cotangents) is not staged: the epilogue finds the places
// from the ray.
template <bool kLit, bool kTextured, bool kColors, bool kMat, bool kInst>
struct SumWords {
  static constexpr bool kNormal = kInst && kLit;
  static constexpr bool kHitPos = kInst && kTextured && (kLit || !kColors);
  static constexpr bool kRay = kInst && kColors;
  static constexpr bool kAlbedo = kMat && kTextured && !kColors;
  static constexpr bool kRm = kMat && kLit && kTextured;
  static constexpr int kNShade = 0;                  // n_shade 3
  static constexpr int kGnw = 3;                     // n_w's cotangent 3
  static constexpr int kGpos = 6 * kNormal;          // obj_pos's cotangent 3
  static constexpr int kGo = kGpos + 3 * kHitPos;    // object origin's 3
  static constexpr int kGd = kGo + 3;                // object direction's 3
  static constexpr int kAlb = kGo + 6 * kRay;        // albedo sample 3
  static constexpr int kRmw = kAlb + 3 * kAlbedo;    // rm.x, rm.y
  static constexpr int kCount = kRmw + 2 * kRm;
};

// Stage word w of the lane whose stage is `st` (the block's stage plus the
// lane's thread index).
__device__ __forceinline__ void put_sum(float* st, int w, float v) {
  st[w * kThreads] = v;
}
__device__ __forceinline__ float got_sum(const float* st, int w) {
  return st[w * kThreads];
}

// a g^T (3 x 3, row-major) added into m.
__device__ __forceinline__ void add_outer(float* m, const float a[3],
                                          const float g[3]) {
  for (int j = 0; j < 3; ++j)
    for (int k = 0; k < 3; ++k) m[3 * j + k] += a[j] * g[k];
}

// A place a and its cotangent g (staged at words w..w + 2) into the
// statistics s: M += a g^T, and G += g for a point.
__device__ __forceinline__ void add_place(float* s, const float* st, int w,
                                          const float a[3], bool point) {
  float g[3];
  for (int c = 0; c < 3; ++c) {
    g[c] = got_sum(st, w + c);
    if (point) s[kStatG + c] += g[c];
  }
  add_outer(s + kStatM, a, g);
}

// The redesign's epilogue of hit lane i: its material cotangents (tint 3,
// roughness, metallic, k) into gm and its instance transform's statistics
// into si, both zeroed by the caller, from its stage `st` and what the
// kernel reads again; `vol` is the lane's volume.  Returns the lane's
// instance in `a` (kInst).
template <bool kLit, bool kTextured, bool kColors, bool kMat, bool kInst>
__device__ __forceinline__ void sums_epilogue(const SurfaceBwdParams& q,
                                              const float* sh_inst,
                                              const float* sh_vol,
                                              long long i, int vol,
                                              const float* st,
                                              float (&gm)[kMatSumWords],
                                              float (&si)[kInstStatWords],
                                              int& a) {
  using W = SumWords<kLit, kTextured, kColors, kMat, kInst>;
  const SurfaceParams& p = q.f;
  a = kInst ? max(p.winner[i], 0) : 0;
  if (kInst) {
    if (W::kNormal) {
      float n_shade[3], g_nw[3];
      for (int c = 0; c < 3; ++c) {
        n_shade[c] = got_sum(st, W::kNShade + c);
        g_nw[c] = got_sum(st, W::kGnw + c);
      }
      add_outer(si + kStatN, n_shade, g_nw);
    }
    if (W::kHitPos || W::kRay) {
      // the places, found from the ray again
      const float* in = sh_inst + a * kInstRow;
      const float t = p.t[i];
      float a_h[3], a_o[3], a_d[3];
      for (int c = 0; c < 3; ++c) {
        const float o_w = p.o_w[3 * i + c], d_w = p.d_w[3 * i + c];
        const float rs = 1.0f / in[7 + c];
        a_h[c] = ((o_w + t * d_w) - in[c]) * rs;
        a_o[c] = (o_w - in[c]) * rs;
        a_d[c] = d_w * rs;
      }
      // the textures' hit point, o_w + t d_w
      if (W::kHitPos) add_place(si, st, W::kGpos, a_h, true);
      // the colour sample's origin (a point) and direction
      if (W::kRay) {
        add_place(si, st, W::kGo, a_o, true);
        add_place(si, st, W::kGd, a_d, false);
      }
    }
  }
  if (kMat) {
    const float* mat = sh_vol + vol * kVolRow;
    if (kLit) {
      const float g_rough = q.g_roughness != nullptr ? q.g_roughness[i]
                                                      : 0.0f;
      const float g_metal = q.g_metallic != nullptr ? q.g_metallic[i]
                                                     : 0.0f;
      if (kTextured) {
        // roughness = clip(R rm.x, 0, 1): R's is the clip's times rm.x
        if (g_rough != 0.0f || g_metal != 0.0f) {
          const float rm0 = got_sum(st, W::kRmw), rm1 = got_sum(st,
                                                              W::kRmw + 1);
          gm[3] += pass_clip(mat[6] * rm0, 0.0f, 1.0f, g_rough) * rm0;
          gm[4] += pass_clip(mat[7] * rm1, 0.0f, 1.0f, g_metal) * rm1;
        }
      } else {
        // roughness = clip(R, 0, 1), metallic = clip(M, 0, 1)
        if (q.g_roughness != nullptr)
          gm[3] += pass_clip(mat[6], 0.0f, 1.0f, g_rough);
        if (q.g_metallic != nullptr)
          gm[4] += pass_clip(mat[7], 0.0f, 1.0f, g_metal);
      }
      if (q.g_k != nullptr) gm[5] += q.g_k[i];
    }
    if (!kColors) {
      float g_alb[3];
      load3(q.g_albedo, i, g_alb);
      // albedo = tint tex (textured), the tint alone (untextured)
      for (int c = 0; c < 3; ++c)
        gm[c] += kTextured ? g_alb[c] * got_sum(st, W::kAlb + c) : g_alb[c];
    }
  }
}

// The redesign's sums of v (N words) of the lanes of a converged warp that
// add (`on`; the others hold zeros) under their `key`, into the warp's own
// partial sums `slot` (N words a key), by plain stores: where every lane
// that adds shares the key, one butterfly (warp_sum), the lanes that hold
// a word's sum adding it; else a segmented merge, each group's lowest lane
// adding its N sums.  No other warp writes the slots, and the lanes that
// add at once name distinct words.
template <int N>
__device__ __forceinline__ void warp_slots_add(float* slot, bool on, int key,
                                               const float (&v)[N],
                                               int lane) {
  const unsigned ons = __ballot_sync(kFullWarp, on);
  if (ons == 0u) return;
  const int lead_key = __shfl_sync(kFullWarp, key, __ffs(ons) - 1);
  if (__all_sync(kFullWarp, !on || key == lead_key)) {
    const float s = warp_sum(v, lane);
    const int e = warp_word<N>(lane);
    if (e < N && warp_word_lead<N>(lane)) slot[lead_key * N + e] += s;
  } else {
    float w[N];
    for (int j = 0; j < N; ++j) w[j] = v[j];
    if (merge_peers32(kFullWarp, on ? key : -1 - lane, w, lane) == lane &&
        on)
      for (int j = 0; j < N; ++j) slot[key * N + j] += w[j];
  }
  __syncwarp();
}

// rotate_bwd(qv, qw, v, g)'s cotangents in the quaternion summed over
// lanes, from m = the sum of v g^T: with w = the sum of v x g and tr =
// trace m, g_qw = 2 qv . w, g_qv = 2 ((m + m^T) qv - 2 tr qv + qw w).
__device__ __forceinline__ void rotate_bwd_summed(const float qv[3], float qw,
                                                  const float* m,
                                                  float g_qv[3],
                                                  float& g_qw) {
  const float w[3] = {m[5] - m[7], m[6] - m[2], m[1] - m[3]};
  const float tr = (m[0] + m[4]) + m[8];
  g_qw = 2.0f * dot3(qv, w);
  for (int j = 0; j < 3; ++j) {
    float s = 0.0f;
    for (int k = 0; k < 3; ++k) s += (m[3 * j + k] + m[3 * k + j]) * qv[k];
    g_qv[j] = 2.0f * ((s - 2.0f * tr * qv[j]) + qw * w[j]);
  }
}

// An instance transform's cotangents (pos 3, rot 4, scale 3) from the sums
// of its lanes' statistics s (kInstStatWords; see kStatM): with R the
// rotation rotate(rot, .) as a matrix (columns rotate(rot, e_j)), pos's is
// -R G / scale; the object-space places' rotation cotangent rotate_bwd on
// the conjugate, its vector part's sign flipped (object_bwd), and their
// scale's -(R_nj M_nj summed over j) / scale_n; the normal's rotation
// cotangent rotate_bwd(rot, n_shade, g_nw scale), its scale's R_kj N_jk
// summed over j.
__device__ __forceinline__ void inst_from_stats(const float* rot,
                                                const float* scale,
                                                const float* s,
                                                float gi[kInstanceWords]) {
  float r[3][3];                 // r[k][j] = rotate(rot, e_j)[k]
  for (int j = 0; j < 3; ++j) {
    float e[3] = {0.0f, 0.0f, 0.0f}, col[3];
    e[j] = 1.0f;
    rotate(rot, rot[3], e, col);
    for (int k = 0; k < 3; ++k) r[k][j] = col[k];
  }
  const float* m = s + kStatM;
  const float* g = s + kStatG;
  const float* n = s + kStatN;
  const float qc[3] = {-rot[0], -rot[1], -rot[2]};
  float gq[3], gw;
  rotate_bwd_summed(qc, rot[3], m, gq, gw);
  // the normal's m' = n_shade (g_nw scale)^T
  float mn[9];
  for (int j = 0; j < 3; ++j)
    for (int k = 0; k < 3; ++k) mn[3 * j + k] = n[3 * j + k] * scale[k];
  float gqn[3], gwn;
  rotate_bwd_summed(rot, rot[3], mn, gqn, gwn);
  for (int k = 0; k < 3; ++k) {
    gi[k] = -((r[k][0] * g[0] + r[k][1] * g[1]) + r[k][2] * g[2]) / scale[k];
    gi[3 + k] = gqn[k] - gq[k];
    gi[7 + k] = ((r[k][0] * n[k] + r[k][1] * n[3 + k]) + r[k][2] * n[6 + k]) -
                ((r[k][0] * m[3 * k] + r[k][1] * m[3 * k + 1]) +
                 r[k][2] * m[3 * k + 2]) / scale[k];
  }
  gi[6] = gwn + gw;
}

// The block's end of the redesign's material sums: its warps' partial sums
// (`slots`, kMatSumWords words a volume) summed and each nonzero word added
// into the accumulator g_mat with one f32 atomic, word e of volume v at
// g_mat[v * kMatRow + e + (e >= 3)] (the rows skip the tint's fourth
// word).  Every thread of the block calls it, after a __syncthreads.
__device__ __forceinline__ void flush_warp_material(float* g_mat,
                                                    const float* slots,
                                                    int volumes) {
  const int words = volumes * kMatSumWords;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < kSumWarps; ++j) s += slots[j * words + w];
    const int v = w / kMatSumWords, e = w - v * kMatSumWords;
    if (s != 0.0f) atomicAdd(g_mat + v * kMatRow + e + (e >= 3), s);
  }
}

// The block's end of the redesign's instance sums: its warps' statistics
// (`slots`, kInstStatWords words an instance) summed into the first warp's,
// then each instance's transform cotangents formed once from them and each
// nonzero word added into g_inst with one f32 atomic.  Every thread of the
// block calls it, after a __syncthreads.
__device__ __forceinline__ void flush_warp_instances(float* g_inst,
                                                     float* slots,
                                                     const float* sh_inst,
                                                     int instances) {
  const int words = instances * kInstStatWords;
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    for (int j = 1; j < kSumWarps; ++j) slots[w] += slots[j * words + w];
  __syncthreads();
  for (int k = threadIdx.x; k < instances; k += blockDim.x) {
    const float* st = slots + k * kInstStatWords;
    bool any = false;
    for (int e = 0; e < kInstStatWords; ++e) any = any || st[e] != 0.0f;
    if (!any) continue;
    float gi[kInstanceWords];
    const float* in = sh_inst + k * kInstRow;
    inst_from_stats(in + 3, in + 7, st, gi);
    for (int e = 0; e < kInstanceWords; ++e)
      if (gi[e] != 0.0f) atomicAdd(g_inst + k * kInstanceWords + e, gi[e]);
  }
}

// The reverse of sample_wrap: the cotangents of (u_, v_) for that of the
// sample.  kTex (the texture variant) also adds the four taps' cotangents
// into `sink` (the stacked textures viewed as [T TH TW, 3]; taps that wrap
// onto one texel add).
template <bool kTex = false>
__device__ __forceinline__ void sample_wrap_bwd(const SurfaceParams& p,
                                                const int* sizes, int id,
                                                float u_, float v_,
                                                const float g[3], float& g_u,
                                                float& g_v,
                                                const TableSink* sink =
                                                    nullptr) {
  const int hi = sizes[2 * id], wi = sizes[2 * id + 1];
  const float h = static_cast<float>(hi), w = static_cast<float>(wi);
  const float u = u_ * w - 0.5f;
  const float v = v_ * h - 0.5f;
  const float u0 = floorf(u), v0 = floorf(v);
  const float fu = u - u0, fv = v - v0;
  const int ua = floor_mod(static_cast<int>(u0), wi);
  const int ub = floor_mod(static_cast<int>(u0 + 1.0f), wi);
  const int va = floor_mod(static_cast<int>(v0), hi);
  const int vb = floor_mod(static_cast<int>(v0 + 1.0f), hi);
  const float* base = p.textures +
                      static_cast<long long>(id) * p.tex_h * p.tex_w * 3;
  const float* c00 = base + (va * p.tex_w + ua) * 3;
  const float* c10 = base + (va * p.tex_w + ub) * 3;
  const float* c01 = base + (vb * p.tex_w + ua) * 3;
  const float* c11 = base + (vb * p.tex_w + ub) * 3;
  float g_fu = 0.0f, g_fv = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float a00 = __ldg(c00 + c), a10 = __ldg(c10 + c);
    const float a01 = __ldg(c01 + c), a11 = __ldg(c11 + c);
    const float top = a00 * (1.0f - fu) + a10 * fu;
    const float bot = a01 * (1.0f - fu) + a11 * fu;
    g_fu += g[c] * ((a10 - a00) * (1.0f - fv) + (a11 - a01) * fv);
    g_fv += g[c] * (bot - top);
  }
  g_u = g_fu * w;
  g_v = g_fv * h;
  if (kTex) {
    const long long t0 = static_cast<long long>(id) * p.tex_h * p.tex_w;
    add_taps(*sink, g, fu, fv, t0 + va * p.tex_w + ua,
             t0 + va * p.tex_w + ub, t0 + vb * p.tex_w + ua,
             t0 + vb * p.tex_w + ub);
  }
}

// The reverse of tri_sample<kNormal>: adds the cotangents of the object
// position and of the blend weights for that of the sample; with kNormal
// the three samples also return their values (the forward's tx, ty, tz).
// kTex (the texture variant) also adds the texture scale's cotangents into
// g_scale (uv = pos / scale, so d uv / d scale = -uv / scale) and, with
// kTaps (its first design), the 12 taps' into `sink`.  A `value` (kNormal
// false) gets the sample itself, tri_sample's blend of the three.
template <bool kNormal, bool kTex = false, bool kTaps = kTex>
__device__ __forceinline__ void tri_sample_bwd(
    const SurfaceParams& p, const int* sizes, int id, const float scale[2],
    const float pos[3], const float b[3], const float g[3], float g_pos[3],
    float g_b[3], const TableSink* sink = nullptr, float* g_scale = nullptr,
    float* value = nullptr) {
  float s[3][3];
  const float uv[3][2] = {{pos[2] / scale[0], pos[1] / scale[1]},
                          {pos[0] / scale[0], pos[2] / scale[1]},
                          {pos[0] / scale[0], pos[1] / scale[1]}};
  const int axes[3][2] = {{2, 1}, {0, 2}, {0, 1}};
  for (int a = 0; a < 3; ++a) {
    sample_wrap(p, sizes, id, uv[a][0], uv[a][1], s[a]);
    float gs[3];
    for (int c = 0; c < 3; ++c) {
      if (kNormal) s[a][c] = s[a][c] * 2.0f - 1.0f;
      gs[c] = (g[c] * b[a]) * (kNormal ? 2.0f : 1.0f);
    }
    g_b[a] += dot3(g, s[a]);
    float g_u, g_v;
    sample_wrap_bwd<kTaps>(p, sizes, id, uv[a][0], uv[a][1], gs, g_u, g_v,
                           sink);
    g_pos[axes[a][0]] += g_u / scale[0];
    g_pos[axes[a][1]] += g_v / scale[1];
    if (kTex) {
      g_scale[0] -= (g_u * uv[a][0]) / scale[0];
      g_scale[1] -= (g_v * uv[a][1]) / scale[1];
    }
  }
  if (!kNormal && value != nullptr)
    for (int c = 0; c < 3; ++c)
      value[c] = (s[0][c] * b[0] + s[1][c] * b[1]) + s[2][c] * b[2];
}

// What the texture variant's redesign stages of a hit lane for its taps (16
// words in shared memory): the object position and the blend weights of
// its triplanar samples, the cotangent of each sample (0 the albedo, 1 the
// tangent normal's unit vector, 2 roughness / metallic; zero where the lane
// takes none) and its volume.
struct TapStage {
  float pos[3], b[3], g[3][3];
  int vol;
};

// The texture variant's redesign: the 9 bilinear samples (3 samples, 3
// planes each) of the lanes of a converged warp that staged theirs
// (`staged`), summed over the warp sample by sample (warp_taps_add).  The
// planes' uv, the samples' cotangents, the floors and the weights are
// tri_sample_bwd's and sample_wrap_bwd's, line for line.
template <bool kLit, bool kColors>
__device__ __forceinline__ void stage_taps_reduce(const SurfaceParams& p,
                                                  const float* sh_vol,
                                                  const int* sh_sizes,
                                                  const TapStage& st,
                                                  bool staged,
                                                  const TableSink& sink,
                                                  int lane) {
  const float* mat = sh_vol + (staged ? st.vol : 0) * kVolRow;
  // a loop, not unrolled: the stage in shared memory holds what it reads
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const int s = k / 3, a = k - 3 * s;
    // unlit: the albedo alone; under per-voxel colours no albedo texture
    if ((!kLit && s > 0) || (kColors && s == 0)) continue;
    float gs[3] = {0.0f, 0.0f, 0.0f};
    if (staged)
      for (int c = 0; c < 3; ++c)
        gs[c] = (st.g[s][c] * st.b[a]) * (s == 1 ? 2.0f : 1.0f);
    const bool on = staged &&
                    !(gs[0] == 0.0f && gs[1] == 0.0f && gs[2] == 0.0f);
    if (!__any_sync(kFullWarp, on)) continue;
    int key = -1, tex[4] = {0, 0, 0, 0};
    float v[12];
    for (int e = 0; e < 12; ++e) v[e] = 0.0f;
    if (on) {
      // tri_sample_bwd's uv of plane a: (z, y), (x, z), (x, y) over scale
      const float u_ = (a == 0 ? st.pos[2] : st.pos[0]) / mat[9];
      const float v__ = (a == 1 ? st.pos[2] : st.pos[1]) / mat[10];
      const int id = __float_as_int(mat[11 + s]);
      const int hi = sh_sizes[2 * id], wi = sh_sizes[2 * id + 1];
      const float h = static_cast<float>(hi), w = static_cast<float>(wi);
      const float u = u_ * w - 0.5f;
      const float vv = v__ * h - 0.5f;
      const float u0 = floorf(u), v0 = floorf(vv);
      const int ua = floor_mod(static_cast<int>(u0), wi);
      const int ub = floor_mod(static_cast<int>(u0 + 1.0f), wi);
      const int va = floor_mod(static_cast<int>(v0), hi);
      const int vb = floor_mod(static_cast<int>(v0 + 1.0f), hi);
      const int t0 = id * p.tex_h * p.tex_w;
      tex[0] = t0 + va * p.tex_w + ua;
      tex[1] = t0 + va * p.tex_w + ub;
      tex[2] = t0 + vb * p.tex_w + ua;
      tex[3] = t0 + vb * p.tex_w + ub;
      key = tex[0];
      tap_values(gs, u - u0, vv - v0, v);
    }
    warp_taps_add(sink, on, key, tex, v, lane);
  }
}

// The reverse of rotate_from_x(v, t): adds the cotangents of v (the
// object-space normal) and of t for that of the rotated vector.
__device__ void rotate_from_x_bwd(const float v[3], const float t[3],
                                  const float g[3], float g_v[3],
                                  float g_t[3]) {
  float q[4];
  const float x[3] = {1.0f, 0.0f, 0.0f};
  cross3(x, v, q);
  q[3] = 1.0f + ((x[0] * v[0] + x[1] * v[1]) + x[2] * v[2]);
  const bool flip = q[3] < 1e-6f;
  if (flip) {
    q[0] = 0.0f;
    q[1] = 0.0f;
    q[2] = 1.0f;
    q[3] = 0.0f;
  }
  const float nrm = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) +
                          q[3] * q[3]);
  const float norm = nmax(nrm, 1e-12f);
  float qn[4];
  for (int c = 0; c < 4; ++c) qn[c] = q[c] / norm;
  float g_qv[3] = {0.0f, 0.0f, 0.0f}, g_qw = 0.0f;
  rotate_bwd(qn, qn[3], t, g, g_qv, g_qw, g_t);
  if (flip) return;           // a constant quaternion
  const float g_qn[4] = {g_qv[0], g_qv[1], g_qv[2], g_qw};
  float dot = 0.0f;
  for (int c = 0; c < 4; ++c) dot += g_qn[c] * q[c];
  const float g_norm = pass_max(nrm, 1e-12f, -dot / (norm * norm));
  float g_q[4];
  for (int c = 0; c < 4; ++c)
    g_q[c] = g_qn[c] / norm + (nrm != 0.0f ? q[c] * (g_norm / nrm) : 0.0f);
  // q = (0, -v2, v1, 1 + v0)
  g_v[0] += g_q[3];
  g_v[1] += g_q[2];
  g_v[2] -= g_q[1];
}

__device__ __forceinline__ void red_add_v4(float* dst, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(dst), "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// The key of a hit cell's voxel rows in the unpacked grid: the cell over a
// side of cn + 1 from -1, which names its 8 corners, or -1 where no corner
// can be inside the grid (its cotangents are all zero).  Lanes with one key
// add into the same 8 rows.
__device__ __forceinline__ long long voxel_key(const SurfaceParams& p,
                                               int vol, const int cell[3]) {
  const long long s1 = p.color_side + 1;
  long long key = vol;
  for (int c = 0; c < 3; ++c) {
    if (cell[c] < -1 || cell[c] >= p.color_side) return -1;
    key = key * s1 + (cell[c] + 1);
  }
  return key;
}

// The reverse of color_sample: adds the cotangents of the object-space ray
// and of t, and returns the 24 cotangents of the cell's corners and where
// they go (the caller adds them into the f32 accumulator): the packed row's
// index, or the unpacked grid's voxel_key.
__device__ __forceinline__ void color_sample_bwd(
    const SurfaceParams& p, long long i, int vol, int n, float h, float ext,
    const float o[3], const float d[3], float t, const float g[3],
    float g_o[3], float g_d[3], float& g_t, long long& row, float grow[24]) {
  int cell[3];
  float q[3];
  for (int c = 0; c < 3; ++c) {
    cell[c] = p.cell[3 * i + c];
    const float base = static_cast<float>(cell[c]) * h - ext;
    q[c] = ((o[c] + d[c] * t) - base) / h;
  }
  const long long packed = color_row(p, vol, cell);
  row = p.colors_unpacked ? voxel_key(p, vol, cell) : packed;
  float g_q[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < 8; ++j) {
    const int b[3] = {j & 1, (j >> 1) & 1, (j >> 2) & 1};
    bool valid = true;
    float w[3], s[3];
    for (int c = 0; c < 3; ++c) {
      const int idx = cell[c] + b[c];
      valid = valid && idx >= 0 && idx < n;
      const float diff = (b[c] ? 0.0f : 1.0f) - q[c];
      w[c] = fabsf(diff);
      s[c] = dabs(diff);
    }
    const float wj = (w[0] * w[1]) * w[2];
    float g_w = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float v = valid ? corner_color(p, packed, vol, cell, j, c) : 0.0f;
      g_w += g[c] * v;
      grow[3 * j + c] = valid ? g[c] * wj : 0.0f;
    }
    // d|1 - b - q| / dq = -dabs(1 - b - q)
    g_q[0] -= (g_w * (w[1] * w[2])) * s[0];
    g_q[1] -= (g_w * (w[0] * w[2])) * s[1];
    g_q[2] -= (g_w * (w[0] * w[1])) * s[2];
  }
  for (int c = 0; c < 3; ++c) {
    const float gq = g_q[c] / h;
    g_o[c] += gq;
    g_d[c] += gq * t;
    g_t += gq * d[c];
  }
}

// A colour row's 24 cotangents into the accumulator: six 16-byte
// reductions, all-zero quadruples skipped.
__device__ __forceinline__ void add_color_row(float* acc, long long row,
                                              const float grow[24]) {
  float* dst = acc + row * 24;
  for (int e = 0; e < 24; e += 4)
    if (grow[e] != 0.0f || grow[e + 1] != 0.0f || grow[e + 2] != 0.0f ||
        grow[e + 3] != 0.0f)
      red_add_v4(dst + e, grow[e], grow[e + 1], grow[e + 2], grow[e + 3]);
}

// A hit cell's 8 x 3 corner cotangents into the unpacked grid's f32
// accumulator [V*cn^3, 3] at the rows its voxel_key names: the 12-byte rows
// take no 16-byte reduction, so one f32 atomic a nonzero component (a
// corner outside the grid has only zeros).
__device__ __forceinline__ void add_color_voxels(float* acc, long long key,
                                                 int side,
                                                 const float grow[24]) {
  const long long s1 = side + 1, nn = side;
  int cell[3];
  for (int c = 2; c >= 0; --c) {
    cell[c] = static_cast<int>(key % s1) - 1;
    key /= s1;
  }
  for (int j = 0; j < 8; ++j) {
    const long long vox =
        ((key * nn + cell[0] + (j & 1)) * nn + cell[1] + ((j >> 1) & 1)) * nn +
        cell[2] + ((j >> 2) & 1);
    for (int c = 0; c < 3; ++c)
      if (grow[3 * j + c] != 0.0f)
        atomicAdd(acc + 3 * vox + c, grow[3 * j + c]);
  }
}

// A hit lane's (or a merged group's) colour cotangents into the accumulator
// of the table's layout; a negative row (an unpacked cell with no corner in
// the grid, a lane without a hit) adds nothing.
__device__ __forceinline__ void add_colors(const SurfaceParams& p, float* acc,
                                           long long row,
                                           const float grow[24]) {
  if (row < 0) return;
  if (p.colors_unpacked) add_color_voxels(acc, row, p.color_side, grow);
  else add_color_row(acc, row, grow);
}


// The surface backward of hit lane i: adds the cotangents of its ray, t
// and n_obj into g_o, g_d, g_t, g_n and, with per-voxel colours, returns its
// colour row and the row's 24 cotangents.  The two kernels below share it.
// kMat (the material variant) also adds the cotangents of the lane's
// material constants into gm (tint's 3, roughness, metallic, k) and names
// its volume in ``vol``; kTex (the texture variant, kTextured only) adds
// the texture scale's into g_scale and every texture tap's into `tex`;
// kInst (the instance variant) adds the cotangents of the lane's instance
// transform into gi (kInstanceWords: pos, rot, scale), from the three
// places the stage reads it: the textures' object-space hit point, the
// colour sample's object-space ray and the world normal.  kSums (the
// material and instance variants' redesign) forms neither gm nor gi: what
// they follow from goes into the lane's stage `ss` (SumWords), and
// sums_epilogue forms them after the lane's code.
template <bool kLit, bool kTextured, bool kColors, bool kMat,
          bool kTex = false, bool kInst = false, bool kStaged = false,
          bool kSums = false>
__device__ __forceinline__ void surface_bwd_hit(
    const SurfaceBwdParams& q, const float* sh_inst, const float* sh_vol,
    const int* sh_sizes, long long i, float g_o[3], float g_d[3],
    float g_n[3], float& g_t, long long& row, float grow[24], float gm[6],
    int& vol_out, const TableSink* tex = nullptr, float* g_scale = nullptr,
    float* gi = nullptr, TapStage* st = nullptr, float* ss = nullptr) {
  // kStaged (the texture variant's redesign): the taps are not added here;
  // what they need goes into the lane's stage `st` (TapStage)
  constexpr bool kTaps = kTex && !kStaged;
  using W = SumWords<kLit, kTextured, kColors, kMat, kInst>;
  const SurfaceParams& p = q.f;
  float o_w[3], d_w[3], n_obj[3];
  for (int c = 0; c < 3; ++c) {
    o_w[c] = p.o_w[3 * i + c];
    d_w[c] = p.d_w[3 * i + c];
    n_obj[c] = p.n_obj[3 * i + c];
  }
  const float t = p.t[i];
  const float* in = sh_inst + max(p.winner[i], 0) * kInstRow;
  const float* pos = in;
  const float* rot = in + 3;
  const float* scale = in + 7;
  const int vol = __float_as_int(in[10]);
  const float* mat = sh_vol + vol * kVolRow;
  const float qc[3] = {-rot[0], -rot[1], -rot[2]};
  vol_out = vol;

  float g_alb[3], g_hp[3], g_nw[3];
  load3(q.g_albedo, i, g_alb);
  load3(q.g_shadow_origin, i, g_hp);       // hit_pos - 0.1 d
  for (int c = 0; c < 3; ++c) g_d[c] = -0.1f * g_hp[c];
  float g_ns[3] = {0.0f, 0.0f, 0.0f};      // of n_shade
  float hit_pos[3];
  for (int c = 0; c < 3; ++c) hit_pos[c] = o_w[c] + t * d_w[c];

  if (kLit) {
    // n_w = rotate(rot, n_shade) * scale, then the mirror direction
    float n_shade[3] = {n_obj[0], n_obj[1], n_obj[2]};
    float obj_pos[3], b[3], tn[3], zxy[3];
    const float* tscale = mat + 9;
    if (kTextured) {
      float a[3];
      for (int c = 0; c < 3; ++c) a[c] = (hit_pos[c] - pos[c]) / scale[c];
      rotate(qc, rot[3], a, obj_pos);
      const float ab[3] = {fabsf(n_obj[0]), fabsf(n_obj[1]),
                           fabsf(n_obj[2])};
      const float s = (ab[0] + ab[1]) + ab[2];
      for (int c = 0; c < 3; ++c) b[c] = s > 0.0f ? ab[c] / s : 0.0f;
      if (kTex && kStaged) {
        for (int c = 0; c < 3; ++c) {
          st->pos[c] = obj_pos[c];
          st->b[c] = b[c];
          st->g[0][c] = st->g[2][c] = 0.0f;
        }
        st->vol = vol;
      }
      tri_sample<true>(p, sh_sizes, __float_as_int(mat[12]), tscale,
                       obj_pos, b, tn);
      const float n2 = dot3(tn, tn);
      const float norm = sqrtf(n2 > 0.0f ? n2 : 1.0f);
      float u[3];
      for (int c = 0; c < 3; ++c) u[c] = n2 > 0.0f ? tn[c] / norm : 0.0f;
      zxy[0] = u[2];
      zxy[1] = u[0];
      zxy[2] = u[1];
      rotate_from_x(n_obj, zxy, n_shade);
    }
    float n_w[3];
    rotate(rot, rot[3], n_shade, n_w);
    for (int c = 0; c < 3; ++c) n_w[c] = n_w[c] * scale[c];
    load3(q.g_n_w, i, g_nw);
    if (p.bounce && q.g_refl_dir != nullptr) {
      const float dn = 2.0f * dot3(d_w, n_w);
      float r[3], g_refl[3], g_r[3];
      for (int c = 0; c < 3; ++c) r[c] = d_w[c] - dn * n_w[c];
      load3(q.g_refl_dir, i, g_refl);
      safe_unit_bwd(r, g_refl, g_r);
      const float g_dn = -dot3(g_r, n_w);
      for (int c = 0; c < 3; ++c) {
        g_d[c] += g_r[c] + (2.0f * g_dn) * n_w[c];
        g_nw[c] += -dn * g_r[c] + (2.0f * g_dn) * d_w[c];
      }
    }
    float g_rs[3];
    for (int c = 0; c < 3; ++c) g_rs[c] = g_nw[c] * scale[c];
    rotate_t(rot, rot[3], g_rs, g_ns);
    if (kInst && kSums) {
      for (int c = 0; c < 3; ++c) {
        put_sum(ss, W::kNShade + c, n_shade[c]);
        put_sum(ss, W::kGnw + c, g_nw[c]);
      }
    } else if (kInst) {
      // n_w = rotate(rot, n_shade) * scale
      float rn[3], unused[3] = {0.0f, 0.0f, 0.0f};
      rotate(rot, rot[3], n_shade, rn);
      for (int c = 0; c < 3; ++c) gi[7 + c] += g_nw[c] * rn[c];
      rotate_bwd(rot, rot[3], n_shade, g_rs, gi + 3, gi[6], unused);
    }

    if (kTextured) {
      float g_pos[3] = {0.0f, 0.0f, 0.0f}, g_b[3] = {0.0f, 0.0f, 0.0f};
      // roughness = clamp(R * rm.x, 0, 1), metallic = clamp(M * rm.y, 0, 1)
      const float g_rough = q.g_roughness != nullptr ? q.g_roughness[i]
                                                      : 0.0f;
      const float g_metal = q.g_metallic != nullptr ? q.g_metallic[i]
                                                     : 0.0f;
      if (g_rough != 0.0f || g_metal != 0.0f) {
        float rm[3];
        tri_sample<false>(p, sh_sizes, __float_as_int(mat[13]), tscale,
                          obj_pos, b, rm);
        const float xr = mat[6] * rm[0], xm = mat[7] * rm[1];
        const float g_rm[3] = {
            pass_clip(xr, 0.0f, 1.0f, g_rough * mat[6]),
            pass_clip(xm, 0.0f, 1.0f, g_metal * mat[7]), 0.0f};
        if (kMat && kSums) {
          put_sum(ss, W::kRmw, rm[0]);
          put_sum(ss, W::kRmw + 1, rm[1]);
        } else if (kMat) {
          // roughness = clip(R rm.x, 0, 1): R's is the clip's times rm.x
          gm[3] += pass_clip(xr, 0.0f, 1.0f, g_rough) * rm[0];
          gm[4] += pass_clip(xm, 0.0f, 1.0f, g_metal) * rm[1];
        }
        tri_sample_bwd<false, kTex, kTaps>(p, sh_sizes,
                                           __float_as_int(mat[13]), tscale,
                                           obj_pos, b, g_rm, g_pos, g_b, tex,
                                           g_scale);
        if (kTex && kStaged)
          for (int c = 0; c < 3; ++c) st->g[2][c] = g_rm[c];
      }
      // n_shade = rotate_from_x(n_obj, zxy(unit(tn)))
      float g_zxy[3] = {0.0f, 0.0f, 0.0f};
      rotate_from_x_bwd(n_obj, zxy, g_ns, g_n, g_zxy);
      const float g_u[3] = {g_zxy[1], g_zxy[2], g_zxy[0]};
      float g_tn[3];
      safe_unit_bwd(tn, g_u, g_tn);
      tri_sample_bwd<true, kTex, kTaps>(p, sh_sizes,
                                        __float_as_int(mat[12]), tscale,
                                        obj_pos, b, g_tn, g_pos, g_b, tex,
                                        g_scale);
      if (kTex && kStaged)
        for (int c = 0; c < 3; ++c) st->g[1][c] = g_tn[c];
      if (!kColors) {
        float g_tex[3], alb[3];
        for (int c = 0; c < 3; ++c) g_tex[c] = g_alb[c] * mat[3 + c];
        tri_sample_bwd<false, kTex, kTaps>(p, sh_sizes,
                                           __float_as_int(mat[11]), tscale,
                                           obj_pos, b, g_tex, g_pos, g_b,
                                           tex, g_scale,
                                           kMat && kSums ? alb : nullptr);
        if (kTex && kStaged)
          for (int c = 0; c < 3; ++c) st->g[0][c] = g_tex[c];
        if (kMat && kSums) {
          for (int c = 0; c < 3; ++c) put_sum(ss, W::kAlb + c, alb[c]);
        } else if (kMat) {
          // albedo = tint tex
          float tex[3];
          tri_sample<false>(p, sh_sizes, __float_as_int(mat[11]), tscale,
                            obj_pos, b, tex);
          for (int c = 0; c < 3; ++c) gm[c] += g_alb[c] * tex[c];
        }
      }
      // b = |n_obj| / sum |n_obj|
      const float ab[3] = {fabsf(n_obj[0]), fabsf(n_obj[1]),
                           fabsf(n_obj[2])};
      const float s = (ab[0] + ab[1]) + ab[2];
      if (s > 0.0f) {
        const float gs = dot3(g_b, ab) / (s * s);
        for (int c = 0; c < 3; ++c)
          g_n[c] += (g_b[c] / s - gs) * dabs(n_obj[c]);
      }
      // obj_pos = rotate(conj(rot), (hit_pos - pos) / scale)
      float g_a[3];
      rotate_t(qc, rot[3], g_pos, g_a);
      for (int c = 0; c < 3; ++c) g_hp[c] += g_a[c] / scale[c];
      if (kInst && kSums) {
        for (int c = 0; c < 3; ++c) put_sum(ss, W::kGpos + c, g_pos[c]);
      } else if (kInst) {
        object_bwd<true>(pos, rot, scale, hit_pos, g_pos, gi);
      }
    } else {
      for (int c = 0; c < 3; ++c) g_n[c] += g_ns[c];
      if (kMat && !kSums) {
        // roughness = clip(R, 0, 1), metallic = clip(M, 0, 1)
        if (q.g_roughness != nullptr)
          gm[3] += pass_clip(mat[6], 0.0f, 1.0f, q.g_roughness[i]);
        if (q.g_metallic != nullptr)
          gm[4] += pass_clip(mat[7], 0.0f, 1.0f, q.g_metallic[i]);
      }
    }
    if (kMat && !kSums && q.g_k != nullptr) gm[5] += q.g_k[i];
  } else if (kTextured && !kColors) {
    // unlit: the albedo alone
    float a[3], obj_pos[3], b[3];
    for (int c = 0; c < 3; ++c) a[c] = (hit_pos[c] - pos[c]) / scale[c];
    rotate(qc, rot[3], a, obj_pos);
    const float ab[3] = {fabsf(n_obj[0]), fabsf(n_obj[1]), fabsf(n_obj[2])};
    const float s = (ab[0] + ab[1]) + ab[2];
    for (int c = 0; c < 3; ++c) b[c] = s > 0.0f ? ab[c] / s : 0.0f;
    float g_pos[3] = {0.0f, 0.0f, 0.0f}, g_b[3] = {0.0f, 0.0f, 0.0f};
    float g_tex[3], alb[3];
    for (int c = 0; c < 3; ++c) g_tex[c] = g_alb[c] * mat[3 + c];
    tri_sample_bwd<false, kTex, kTaps>(p, sh_sizes, __float_as_int(mat[11]),
                                       mat + 9, obj_pos, b, g_tex, g_pos, g_b,
                                       tex, g_scale,
                                       kMat && kSums ? alb : nullptr);
    if (kTex && kStaged) {
      for (int c = 0; c < 3; ++c) {
        st->pos[c] = obj_pos[c];
        st->b[c] = b[c];
        st->g[0][c] = g_tex[c];
      }
      st->vol = vol;
    }
    if (kMat && kSums) {
      for (int c = 0; c < 3; ++c) put_sum(ss, W::kAlb + c, alb[c]);
    } else if (kMat) {
      float tex[3];
      tri_sample<false>(p, sh_sizes, __float_as_int(mat[11]), mat + 9,
                        obj_pos, b, tex);
      for (int c = 0; c < 3; ++c) gm[c] += g_alb[c] * tex[c];
    }
    if (s > 0.0f) {
      const float gs = dot3(g_b, ab) / (s * s);
      for (int c = 0; c < 3; ++c)
        g_n[c] += (g_b[c] / s - gs) * dabs(n_obj[c]);
    }
    float g_a[3];
    rotate_t(qc, rot[3], g_pos, g_a);
    for (int c = 0; c < 3; ++c) g_hp[c] += g_a[c] / scale[c];
    if (kInst && kSums) {
      for (int c = 0; c < 3; ++c) put_sum(ss, W::kGpos + c, g_pos[c]);
    } else if (kInst) {
      object_bwd<true>(pos, rot, scale, hit_pos, g_pos, gi);
    }
  }

  // the albedo of an untextured lane without per-voxel colours: the tint
  if (kMat && !kSums && !kTextured && !kColors)
    for (int c = 0; c < 3; ++c) gm[c] += g_alb[c];

  // hit_pos = o_w + t d_w
  for (int c = 0; c < 3; ++c) {
    g_o[c] += g_hp[c];
    g_d[c] += t * g_hp[c];
  }
  g_t += dot3(g_hp, d_w);

  if (kColors) {
    float a[3], bb[3], o[3], d[3];
    for (int c = 0; c < 3; ++c) {
      a[c] = (o_w[c] - pos[c]) / scale[c];
      bb[c] = d_w[c] / scale[c];
    }
    rotate(qc, rot[3], a, o);
    rotate(qc, rot[3], bb, d);
    float g_oo[3] = {0.0f, 0.0f, 0.0f}, g_dd[3] = {0.0f, 0.0f, 0.0f};
    color_sample_bwd(p, i, vol, __float_as_int(mat[0]), mat[1], mat[2], o, d,
                     t, g_alb, g_oo, g_dd, g_t, row, grow);
    float ga[3], gb[3];
    rotate_t(qc, rot[3], g_oo, ga);
    rotate_t(qc, rot[3], g_dd, gb);
    for (int c = 0; c < 3; ++c) {
      g_o[c] += ga[c] / scale[c];
      g_d[c] += gb[c] / scale[c];
    }
    if (kInst && kSums) {
      for (int c = 0; c < 3; ++c) {
        put_sum(ss, W::kGo + c, g_oo[c]);
        put_sum(ss, W::kGd + c, g_dd[c]);
      }
    } else if (kInst) {
      object_bwd<true>(pos, rot, scale, o_w, g_oo, gi);
      object_bwd<false>(pos, rot, scale, d_w, g_dd, gi);
    }
  }
}

// The first design, kept as the comparator of the merged kernel: one thread
// a ray over the whole grid, tables staged by every block, each hit lane's
// six reductions issued on their own (the material variant's too, into the
// block's partial sums).
template <bool kLit, bool kTextured, bool kColors, bool kMat>
__global__ void __launch_bounds__(kThreads) surface_bwd_kernel(
    const SurfaceBwdParams q) {
  const SurfaceParams& p = q.f;
  extern __shared__ float sh[];
  float* sh_inst = sh;
  float* sh_vol = sh_inst + p.inst.count * kInstRow;
  int* sh_sizes = reinterpret_cast<int*>(sh_vol + p.mat.count * kVolRow);
  float* sh_mat = reinterpret_cast<float*>(sh_sizes + 2 * p.tex_count);
  stage_surface_tables(p, sh_inst, sh_vol, sh_sizes);
  if (kMat)
    for (int w = threadIdx.x; w < p.mat.count * kMatRow; w += blockDim.x)
      sh_mat[w] = 0.0f;
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.rays) {
    if (!kMat) return;
  } else {
    float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
    float g_n[3] = {0.0f, 0.0f, 0.0f}, g_t = 0.0f;
    if (p.hit[i]) {
      long long row = -1;
      float grow[24];
      float gm[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      int vol = 0;
      surface_bwd_hit<kLit, kTextured, kColors, kMat>(
          q, sh_inst, sh_vol, sh_sizes, i, g_o, g_d, g_n, g_t, row, grow, gm,
          vol);
      if (kColors && q.g_colors != nullptr)
        add_colors(p, q.g_colors, row, grow);
      if (kMat) add_material(sh_mat, vol, gm);
    }
    if (q.g_o_w != nullptr) {
      store3(q.g_o_w, i, g_o);
      store3(q.g_d_w, i, g_d);
    }
    q.g_t[i] = g_t;
    store3(q.g_n_obj, i, g_n);
  }
  if (kMat) flush_material(q, sh_mat);
}


// The redesign.  Blocks stay resident and stride over the rays (the tables
// are staged once a block, not once every 256 rays); a warp without a hit
// writes its zeros in 16-byte stores; the lanes of a warp that hit one
// colour row merge their cotangents before the row's lowest such lane issues
// its six reductions (with the unpacked grid, the lanes of one cell before
// its lowest adds into the cell's 8 voxel rows).  Each lane's own cotangents are computed as in the
// first design.

// Blocks an SM must hold at once, a register cap: at 3 (80 registers, 24
// of 64 warp slots, a few spills in the lit textured variants) the launch
// on the primary rays, latency-bound in its hit lanes, gains more than the
// spills cost (vrt_torch.apps.probe_caps times the caps).
constexpr int kSurfaceBwdMinBlocks = 3;

// The merged kernel's body; kTex (the texture variant, kTextured only)
// also keeps a block's partial sums of the texture scale's cotangents by
// volume beside the material's (a warp's lanes merged by volume first) and
// adds each texture tap's cotangents into the block's partial sums of the
// stacked textures in shared memory (tex_shared) or into their accumulator,
// a warp's lanes on one texel merged first (add_texel); kInst (the instance
// variant) keeps a block's partial sums of the instance transforms'
// cotangents after them (a warp's lanes merged by instance first), added
// into g_inst once at the block's end.  kStaged (the texture variant's
// redesign) takes the taps out of the hit lanes' code: each hit lane stages
// what they need (TapStage) and the warp sums its 9 samples after the lanes'
// code (stage_taps_reduce).  The probe's kTapSink 1 adds no tap into the
// textures (no zeroing, no flush), 3 flushes nothing of them.  kWarpSums
// (the material and instance variants' redesign, surface_bwd_sums_kernel)
// stages what a hit lane's material and instance cotangents follow from
// (SumWords), forms them after the lane's code (sums_epilogue) and sums
// them over the warp into the warp's partial sums (warp_slots_add), which
// the block adds into g_mat and g_inst at its end; shared memory after the
// tables and the texture variant's: the warps' material sums [kSumWarps,
// V, kMatSumWords], their instance statistics [kSumWarps, I,
// kInstStatWords], the stage [SumWords::kCount, kThreads].
template <bool kLit, bool kTextured, bool kColors, bool kMat, bool kTex,
          bool kInst = false, bool kStaged = false, bool kWarpSums = false>
__device__ __forceinline__ void surface_bwd_merged_body(
    const SurfaceBwdParams& q) {
  const SurfaceParams& p = q.f;
  extern __shared__ float sh[];
  TapStage* stage = nullptr;
  if constexpr (kTex && kStaged) {
    __shared__ TapStage stages[kThreads];
    stage = stages + threadIdx.x;
  }
  float* sh_inst = sh;
  float* sh_vol = sh_inst + p.inst.count * kInstRow;
  int* sh_sizes = reinterpret_cast<int*>(sh_vol + p.mat.count * kVolRow);
  float* sh_mat = reinterpret_cast<float*>(sh_sizes + 2 * p.tex_count);
  // the first design's block sums of the material constants
  const int mat_words = kMat && !kWarpSums ? p.mat.count * kMatRow : 0;
  float* sh_scale = sh_mat + mat_words;
  float* sh_tex = sh_scale + p.mat.count * kTexScaleRow;
  const long long tex_words =
      static_cast<long long>(p.tex_count) * p.tex_h * p.tex_w * 3;
  // the instance variant's sums, after what the host allotted before them
  float* sh_ig = sh_mat + mat_words +
                 (kTex ? p.mat.count * kTexScaleRow +
                             (q.tex_shared ? tex_words : 0)
                       : 0);
  // the redesign's: the warps' partial sums, then the stage
  const int wmat_words = kMat ? p.mat.count * kMatSumWords : 0;
  const int winst_words = kInst ? p.inst.count * kInstStatWords : 0;
  float* sh_wmat = sh_ig;
  float* sh_winst = sh_wmat + kSumWarps * wmat_words;
  float* sh_sums = sh_winst + kSumWarps * winst_words;
  const int warp = threadIdx.x >> 5;
  stage_surface_tables(p, sh_inst, sh_vol, sh_sizes);
  if (kWarpSums)
    for (int w = threadIdx.x; w < kSumWarps * (wmat_words + winst_words);
         w += blockDim.x)
      sh_wmat[w] = 0.0f;
  if (kMat && !kWarpSums)
    for (int w = threadIdx.x; w < p.mat.count * kMatRow; w += blockDim.x)
      sh_mat[w] = 0.0f;
  if (kTex) {
    for (int w = threadIdx.x; w < p.mat.count * kTexScaleRow;
         w += blockDim.x)
      sh_scale[w] = 0.0f;
    if (q.tex_shared && kTapSink != 1)
      for (long long w = threadIdx.x; w < tex_words; w += blockDim.x)
        sh_tex[w] = 0.0f;
  }
  if (kInst && !kWarpSums)
    for (int w = threadIdx.x; w < p.inst.count * kInstanceWords;
         w += blockDim.x)
      sh_ig[w] = 0.0f;
  __syncthreads();
  const TableSink tex_sink{kTex && q.tex_shared ? sh_tex : nullptr,
                           q.g_textures};

  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < p.rays; base += stride) {
    const long long i = base + threadIdx.x;
    const long long w0 = i - lane;             // the warp's first ray
    const bool in = i < p.rays;
    const bool is_hit = in && p.hit[i];
    if (__ballot_sync(kFullWarp, is_hit) == 0u && w0 + 32 <= p.rays) {
      // 32 miss lanes: [32,3] floats are 24 float4s, [32] are 8
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lane < 24) {
        if (q.g_o_w != nullptr) {
          reinterpret_cast<float4*>(q.g_o_w + 3 * w0)[lane] = z;
          reinterpret_cast<float4*>(q.g_d_w + 3 * w0)[lane] = z;
        }
        reinterpret_cast<float4*>(q.g_n_obj + 3 * w0)[lane] = z;
      }
      if (lane < 8) reinterpret_cast<float4*>(q.g_t + w0)[lane] = z;
      continue;
    }
    float g_o[3] = {0.0f, 0.0f, 0.0f}, g_d[3] = {0.0f, 0.0f, 0.0f};
    float g_n[3] = {0.0f, 0.0f, 0.0f}, g_t = 0.0f;
    long long row = -1 - lane;                 // distinct: no peers
    float grow[24];
    float gm[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float g_scale[2] = {0.0f, 0.0f};
    float gi[kInstanceWords];
    if (kInst)
      for (int e = 0; e < kInstanceWords; ++e) gi[e] = 0.0f;
    int vol = 0;
    if (is_hit)
      surface_bwd_hit<kLit, kTextured, kColors, kMat, kTex, kInst, kStaged,
                      kWarpSums>(q, sh_inst, sh_vol, sh_sizes, i, g_o, g_d,
                                 g_n, g_t, row, grow, gm, vol, &tex_sink,
                                 g_scale, gi, stage,
                                 sh_sums + threadIdx.x);
    if (kColors && q.g_colors != nullptr) {
      if (!is_hit)
        for (int e = 0; e < 24; ++e) grow[e] = 0.0f;
      if (merge_peers(row, grow, lane) == lane)
        add_colors(p, q.g_colors, row, grow);
    }
    if (kMat && !kWarpSums) {
      // the lanes of one volume summed first, the lowest adding the sums
      const long long key = is_hit ? vol : -1 - lane;
      if (merge_peers(key, gm, lane) == lane && is_hit)
        add_material(sh_mat, vol, gm);
    }
    if (kTex) {
      const long long key = is_hit ? vol : -1 - lane;
      if (merge_peers(key, g_scale, lane) == lane && is_hit)
        for (int c = 0; c < kTexScaleRow; ++c)
          if (g_scale[c] != 0.0f)
            atomicAdd(sh_scale + vol * kTexScaleRow + c, g_scale[c]);
    }
    if (kInst && !kWarpSums) {
      // the lanes of one instance summed first, the lowest adding the sums
      const int a = is_hit ? max(p.winner[i], 0) : 0;
      const long long key = is_hit ? a : -1 - lane;
      if (merge_peers(key, gi, lane) == lane && is_hit)
        for (int e = 0; e < kInstanceWords; ++e)
          if (gi[e] != 0.0f) atomicAdd(sh_ig + a * kInstanceWords + e, gi[e]);
    }
    if (kWarpSums) {
      // the lane's cotangents first, then its table cotangents formed from
      // its stage and summed over the warp
      if (in) {
        if (q.g_o_w != nullptr) {
          store3(q.g_o_w, i, g_o);
          store3(q.g_d_w, i, g_d);
        }
        q.g_t[i] = g_t;
        store3(q.g_n_obj, i, g_n);
      }
      float sm[kMatSumWords], si[kInstStatWords];
      for (int e = 0; e < kMatSumWords; ++e) sm[e] = 0.0f;
      for (int e = 0; e < kInstStatWords; ++e) si[e] = 0.0f;
      int a = 0;
      if (is_hit)
        sums_epilogue<kLit, kTextured, kColors, kMat, kInst>(
            q, sh_inst, sh_vol, i, vol, sh_sums + threadIdx.x, sm, si, a);
      if (kMat)
        warp_slots_add(sh_wmat + warp * wmat_words, is_hit, vol, sm, lane);
      if (kInst)
        warp_slots_add(sh_winst + warp * winst_words, is_hit, a, si, lane);
      if (kTex && kStaged && (kLit || !kColors))
        stage_taps_reduce<kLit, kColors>(p, sh_vol, sh_sizes, *stage,
                                         is_hit, tex_sink, lane);
      continue;
    }
    if (kTex && kStaged) {
      // the lane's cotangents first, then the warp's taps (every hit lane
      // of a textured mode staged its samples; unlit under per-voxel
      // colours takes none)
      if (in) {
        if (q.g_o_w != nullptr) {
          store3(q.g_o_w, i, g_o);
          store3(q.g_d_w, i, g_d);
        }
        q.g_t[i] = g_t;
        store3(q.g_n_obj, i, g_n);
      }
      if (kLit || !kColors)
        stage_taps_reduce<kLit, kColors>(p, sh_vol, sh_sizes, *stage,
                                         is_hit, tex_sink, lane);
      continue;
    }
    if (!in) continue;
    if (q.g_o_w != nullptr) {
      store3(q.g_o_w, i, g_o);
      store3(q.g_d_w, i, g_d);
    }
    q.g_t[i] = g_t;
    store3(q.g_n_obj, i, g_n);
  }
  if (kWarpSums) {
    __syncthreads();
    if (kMat) flush_warp_material(q.g_mat, sh_wmat, p.mat.count);
    if (kInst)
      flush_warp_instances(q.g_inst, sh_winst, sh_inst, p.inst.count);
  }
  if (kMat && !kWarpSums) flush_material(q, sh_mat);
  if (kTex) {
    __syncthreads();
    flush_table(q.g_tex_scale, sh_scale, p.mat.count * kTexScaleRow);
    if (q.tex_shared && kTapSink != 1 && kTapSink != 3)
      flush_table(q.g_textures, sh_tex, tex_words);
  }
  if (kInst && !kWarpSums) {
    __syncthreads();
    flush_table(q.g_inst, sh_ig, p.inst.count * kInstanceWords);
  }
}

template <bool kLit, bool kTextured, bool kColors, bool kMat>
__global__ void __launch_bounds__(kThreads, kSurfaceBwdMinBlocks)
    surface_bwd_merged_kernel(const SurfaceBwdParams q) {
  surface_bwd_merged_body<kLit, kTextured, kColors, kMat, false>(q);
}

// The texture variant of the merged kernel (kTextured; kMat as the
// material variant's): instantiated apart, so that the default launches'
// kernels stay as they were.
template <bool kLit, bool kColors, bool kMat>
__global__ void __launch_bounds__(kThreads, kSurfaceBwdMinBlocks)
    surface_bwd_textures_kernel(const SurfaceBwdParams q) {
  surface_bwd_merged_body<kLit, true, kColors, kMat, true>(q);
}

// The texture variant's redesign (kMat as the material variant's): the
// merged body with the taps staged and summed by the warp after the hit
// lanes' code (kStaged), the default; the kernel above, the first design,
// stays as its comparator.
template <bool kLit, bool kColors, bool kMat>
__global__ void __launch_bounds__(kThreads, kSurfaceBwdMinBlocks)
    surface_bwd_textures_warp_kernel(const SurfaceBwdParams q) {
  surface_bwd_merged_body<kLit, true, kColors, kMat, true, false, true>(q);
}

// The instance variant of the merged kernel (kInst; kMat and kTex as the
// material and texture variants', so that one launch runs all three that a
// step asks for): instantiated apart, so that the default launches' and
// the other variants' kernels stay as they were.
template <bool kLit, bool kTextured, bool kColors, bool kMat, bool kTex>
__global__ void __launch_bounds__(kThreads, kSurfaceBwdMinBlocks)
    surface_bwd_instances_kernel(const SurfaceBwdParams q) {
  // its texture path the redesign's (kStaged)
  surface_bwd_merged_body<kLit, kTextured, kColors, kMat, kTex, true, kTex>(
      q);
}

// The material and instance variants' redesign (kWarpSums): the material
// variant alone (kMat, not kInst), the instance variant (kInst; kMat and
// kTex as the material and texture variants', one launch of all that a
// step asks for; its texture path the texture variant's redesign).  The
// kernels above, the first designs, stay as its comparator.
template <bool kLit, bool kTextured, bool kColors, bool kMat, bool kTex,
          bool kInst>
__global__ void __launch_bounds__(kThreads, kSurfaceBwdMinBlocks)
    surface_bwd_sums_kernel(const SurfaceBwdParams q) {
  surface_bwd_merged_body<kLit, kTextured, kColors, kMat, kTex, kInst, kTex,
                          true>(q);
}

template <typename T>
const T* at(const void* const* ptrs, int i) {
  return static_cast<const T*>(ptrs[i]);
}

Lights lights_from(const void* const* ptrs, int first, int points, int spots) {
  return Lights{at<float>(ptrs, first),      at<float>(ptrs, first + 1),
                at<float>(ptrs, first + 2),  at<float>(ptrs, first + 3),
                at<float>(ptrs, first + 4),  at<float>(ptrs, first + 5),
                at<float>(ptrs, first + 6),  at<float>(ptrs, first + 7),
                at<float>(ptrs, first + 8),  at<float>(ptrs, first + 9),
                at<float>(ptrs, first + 10), at<float>(ptrs, first + 11),
                at<float>(ptrs, first + 12), at<float>(ptrs, first + 13),
                at<float>(ptrs, first + 14), points, spots};
}

// The surface kernels' inputs: ptrs[0..24] and ints (see vrt_shade_surface).
void surface_inputs(const void* const* ptrs, const int* ints, long long rays,
                    SurfaceParams& p) {
  p.o_w = at<float>(ptrs, 0);
  p.d_w = at<float>(ptrs, 1);
  p.t = at<float>(ptrs, 2);
  p.n_obj = at<float>(ptrs, 3);
  p.hit = at<uint8_t>(ptrs, 4);
  p.cell = at<int32_t>(ptrs, 5);
  p.winner = at<int32_t>(ptrs, 6);
  p.inst = Instances{at<int32_t>(ptrs, 7), at<float>(ptrs, 8),
                     at<float>(ptrs, 9), at<float>(ptrs, 10), nullptr,
                     ints[0]};
  p.mat = Materials{at<int32_t>(ptrs, 11), at<float>(ptrs, 12),
                    at<float>(ptrs, 13), at<float>(ptrs, 14),
                    at<float>(ptrs, 15), at<float>(ptrs, 16),
                    at<float>(ptrs, 17), at<float>(ptrs, 18),
                    at<int32_t>(ptrs, 19), at<int32_t>(ptrs, 20),
                    at<int32_t>(ptrs, 21), ints[1]};
  p.textures = at<float>(ptrs, 22);
  p.tex_sizes = at<int32_t>(ptrs, 23);
  p.tex_count = ints[2];
  p.tex_h = ints[3];
  p.tex_w = ints[4];
  p.colors = ptrs[24];
  p.color_side = ints[5];
  p.colors_bf16 = ints[6] == 1;
  p.colors_unpacked = ints[6] == 2;
  p.bounce = ints[10];
  p.shadows = ints[11];
  p.rays = rays;
}

constexpr int kLightPtrs = 15;
// The combine kernels' inputs: ptrs[0..38] and ints (see vrt_shade_combine).
void combine_inputs(const void* const* ptrs, const int* ints, long long rays,
                    CombineParams& p) {
  p.d_w = at<float>(ptrs, 0);
  p.n_obj = at<float>(ptrs, 1);
  p.hit = at<uint8_t>(ptrs, 2);
  p.unlit = at<uint8_t>(ptrs, 3);
  p.albedo = at<float>(ptrs, 4);
  p.shadow_origin = at<float>(ptrs, 5);
  p.n_w = at<float>(ptrs, 6);
  p.roughness = at<float>(ptrs, 7);
  p.metallic = at<float>(ptrs, 8);
  p.k = at<float>(ptrs, 9);
  p.refl_dir = at<float>(ptrs, 10);
  p.refl_rgb = at<float>(ptrs, 11);
  for (int j = 0; j < kMaxBlocked; ++j) p.blocked[j] = at<uint8_t>(ptrs, 12 + j);
  p.lights = lights_from(ptrs, 12 + kMaxBlocked, ints[2], ints[3]);
  p.env = at<float>(ptrs, 12 + kMaxBlocked + kLightPtrs);
  p.env_side = ints[4];
  p.lit = ints[0];
  p.final = ints[1];
  p.rays = rays;
  p.out = nullptr;
}

constexpr int kMaxSharedBytes = 48 * 1024;

struct Grid {
  cudaError_t err;
  long long blocks;
};

// The SMs times the blocks of `kernel` (blocks of `threads`) that an SM holds
// at once by their threads, registers and static shared memory (a block's
// staged tables, at most 48 KiB, leave room for 4) and `shared` bytes of
// dynamic shared memory: the grid of a kernel whose resident blocks stride
// over the rays.  Each caller keeps it per variant, found on the card of
// its first launch (the variants whose shared memory follows their tables
// per kernel, dynamic shared size and card: sized_grid): the grid only
// sizes the stride loop, and any grid gives the same result.
Grid resident_grid(const void* kernel, int threads, size_t shared = 0) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, shared);
  return Grid{e, static_cast<long long>(max(per_sm, 1)) * sms};
}

// resident_grid kept per kernel, dynamic shared size and card: the first
// launch of each asks the card, later ones read it here (the launches come
// from any host thread).
Grid sized_grid(const void* kernel, int threads, size_t shared) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, size_t, int>, Grid> grids;
  int device = 0;
  const cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return Grid{e, 0};
  const auto key = std::make_tuple(kernel, shared, device);
  std::lock_guard<std::mutex> hold(lock);
  const auto found = grids.find(key);
  if (found != grids.end()) return found->second;
  const Grid g = resident_grid(kernel, threads, shared);
  if (g.err == cudaSuccess) grids.emplace(key, g);
  return g;
}

// Lets `kernel` take up to `bytes` of dynamic shared memory (above 48 KiB
// only once asked for) on the current card: asked once a kernel and card.
cudaError_t allow_shared(const void* kernel, int bytes) {
  static std::mutex lock;
  static std::set<std::pair<const void*, int>> allowed;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(lock);
  if (allowed.count({kernel, device})) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) allowed.emplace(kernel, device);
  return e;
}

template <bool kLit, bool kTextured, bool kColors, bool kMat>
Grid merged_grid() {
  static const Grid grid = resident_grid(
      reinterpret_cast<const void*>(
          surface_bwd_merged_kernel<kLit, kTextured, kColors, kMat>),
      kThreads);
  return grid;
}

// One launch of the surface backward's texture variant over `blocks`
// blocks of rays, on its resident grid for `shared` bytes: the redesign
// (surface_bwd_textures_warp_kernel), or with `first` its first design.
template <bool kLit, bool kColors, bool kMat>
cudaError_t surface_bwd_textures(const SurfaceBwdParams& q, bool first,
                                 long long blocks, size_t shared,
                                 cudaStream_t s) {
  const void* kernel =
      first ? reinterpret_cast<const void*>(
                  surface_bwd_textures_kernel<kLit, kColors, kMat>)
            : reinterpret_cast<const void*>(
                  surface_bwd_textures_warp_kernel<kLit, kColors, kMat>);
  const Grid g = sized_grid(kernel, kThreads, shared);
  if (g.err != cudaSuccess) return g.err;
  const unsigned grid = static_cast<unsigned>(std::min(blocks, g.blocks));
  if (first)
    surface_bwd_textures_kernel<kLit, kColors, kMat>
        <<<grid, kThreads, shared, s>>>(q);
  else
    surface_bwd_textures_warp_kernel<kLit, kColors, kMat>
        <<<grid, kThreads, shared, s>>>(q);
  return cudaSuccess;
}

// One launch of the surface backward's instance variant (kMat and kTex by
// `material` and `textures`; kTex in a textured mode alone) over `blocks`
// blocks of rays, on its resident grid for `shared` bytes.
template <bool kLit, bool kTextured, bool kColors, bool kMat, bool kTex>
cudaError_t surface_bwd_instances_launch(const SurfaceBwdParams& q,
                                         long long blocks, size_t shared,
                                         cudaStream_t s) {
  const Grid g = sized_grid(
      reinterpret_cast<const void*>(
          surface_bwd_instances_kernel<kLit, kTextured, kColors, kMat, kTex>),
      kThreads, shared);
  if (g.err != cudaSuccess) return g.err;
  surface_bwd_instances_kernel<kLit, kTextured, kColors, kMat, kTex>
      <<<static_cast<unsigned>(std::min(blocks, g.blocks)), kThreads, shared,
         s>>>(q);
  return cudaSuccess;
}

// One launch of the material and instance variants' redesign
// (surface_bwd_sums_kernel) over `blocks` blocks of rays, on its resident
// grid: `tables` bytes of dynamic shared memory (the staged tables and the
// texture variant's sums) and its own after them.
template <bool kLit, bool kTextured, bool kColors, bool kMat, bool kTex,
          bool kInst>
cudaError_t surface_bwd_sums_launch(const SurfaceBwdParams& q,
                                    long long blocks, size_t tables,
                                    cudaStream_t s) {
  using W = SumWords<kLit, kTextured, kColors, kMat, kInst>;
  const size_t shared =
      tables + 4 * (static_cast<size_t>(kSumWarps) *
                        ((kMat ? q.f.mat.count * kMatSumWords : 0) +
                         (kInst ? q.f.inst.count * kInstStatWords : 0)) +
                    static_cast<size_t>(W::kCount) * kThreads);
  if (shared > kSumsMaxSharedBytes) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(
      surface_bwd_sums_kernel<kLit, kTextured, kColors, kMat, kTex, kInst>);
  const cudaError_t allowed = allow_shared(kernel, kSumsMaxSharedBytes);
  if (allowed != cudaSuccess) return allowed;
  const Grid g = sized_grid(kernel, kThreads, shared);
  if (g.err != cudaSuccess) return g.err;
  surface_bwd_sums_kernel<kLit, kTextured, kColors, kMat, kTex, kInst>
      <<<static_cast<unsigned>(std::min(blocks, g.blocks)), kThreads, shared,
         s>>>(q);
  return cudaSuccess;
}

template <bool kLit, bool kTextured, bool kColors>
cudaError_t surface_bwd_instances(const SurfaceBwdParams& q, bool material,
                                  bool textures, long long blocks,
                                  size_t shared, cudaStream_t s) {
  if (kTextured && textures)
    return material ? surface_bwd_instances_launch<kLit, kTextured, kColors,
                                                   true, kTextured>(
                          q, blocks, shared, s)
                    : surface_bwd_instances_launch<kLit, kTextured, kColors,
                                                   false, kTextured>(
                          q, blocks, shared, s);
  return material ? surface_bwd_instances_launch<kLit, kTextured, kColors,
                                                 true, false>(q, blocks,
                                                              shared, s)
                  : surface_bwd_instances_launch<kLit, kTextured, kColors,
                                                 false, false>(q, blocks,
                                                               shared, s);
}

// A launch of the material variant alone (not `instances`) or of the
// instance variant (kMat and kTex by `material` and `textures`; kTex in a
// textured mode alone): the redesign, or with `first` the first design
// (surface_bwd_merged_kernel's kMat instantiation, surface_bwd_instances_
// kernel) on `shared` bytes; the redesign takes `tables` bytes and its own.
template <bool kLit, bool kTextured, bool kColors>
cudaError_t surface_bwd_sums(const SurfaceBwdParams& q, bool material,
                             bool textures, bool instances, bool first,
                             long long blocks, size_t shared, size_t tables,
                             cudaStream_t s) {
  if (!instances) {
    if (!first)
      return surface_bwd_sums_launch<kLit, kTextured, kColors, true, false,
                                     false>(q, blocks, tables, s);
    const Grid g = merged_grid<kLit, kTextured, kColors, true>();
    if (g.err != cudaSuccess) return g.err;
    surface_bwd_merged_kernel<kLit, kTextured, kColors, true>
        <<<static_cast<unsigned>(std::min(blocks, g.blocks)), kThreads,
           shared, s>>>(q);
    return cudaSuccess;
  }
  if (first) return surface_bwd_instances<kLit, kTextured, kColors>(
      q, material, textures, blocks, shared, s);
  if (kTextured && textures)
    return material
               ? surface_bwd_sums_launch<kLit, kTextured, kColors, true,
                                         kTextured, true>(q, blocks, tables, s)
               : surface_bwd_sums_launch<kLit, kTextured, kColors, false,
                                         kTextured, true>(q, blocks, tables,
                                                          s);
  return material ? surface_bwd_sums_launch<kLit, kTextured, kColors, true,
                                            false, true>(q, blocks, tables, s)
                  : surface_bwd_sums_launch<kLit, kTextured, kColors, false,
                                            false, true>(q, blocks, tables,
                                                         s);
}

// One launch of a forward kernel's redesign over `rays`: its grid, or its
// error.  With kFwdResident false (a probe's build) one thread a ray.
template <typename Kernel, typename Params>
cudaError_t launch_resident(Kernel kernel, const Grid& g, const Params& p,
                            size_t shared, cudaStream_t s) {
  if (g.err != cudaSuccess) return g.err;
  const long long blocks = (p.rays + kFwdThreads - 1) / kFwdThreads;
  kernel<<<static_cast<unsigned>(kFwdResident ? std::min(blocks, g.blocks)
                                              : blocks),
           kFwdThreads, shared, s>>>(p);
  return cudaSuccess;
}

template <bool kLit, bool kTextured, bool kColors, bool kVec>
cudaError_t surface_resident(const SurfaceParams& p, size_t shared,
                             cudaStream_t s) {
  static const Grid grid = resident_grid(
      reinterpret_cast<const void*>(
          surface_resident_kernel<kLit, kTextured, kColors, kVec>),
      kFwdThreads);
  return launch_resident(surface_resident_kernel<kLit, kTextured, kColors,
                                                 kVec>,
                         grid, p, shared, s);
}

template <bool kVec>
cudaError_t combine_resident(const CombineParams& p, size_t shared,
                             cudaStream_t s) {
  static const Grid grid = resident_grid(
      reinterpret_cast<const void*>(combine_resident_kernel<kVec>),
      kFwdThreads);
  return launch_resident(combine_resident_kernel<kVec>, grid, p, shared, s);
}

// A surface launch of any design: 0 the first (one thread a ray over the
// whole grid), 1 the resident redesign on the scalar path, 2 on the vector
// path, 3 the design for the unpacked voxel grid.
template <bool kLit, bool kTextured, bool kColors>
cudaError_t surface_launch(const SurfaceParams& p, int design, size_t shared,
                           cudaStream_t s) {
  if (design == 3) {
    surface_voxels_kernel<kLit, kTextured>
        <<<static_cast<unsigned>((p.rays + kVoxelThreads - 1) /
                                 kVoxelThreads),
           kVoxelThreads, shared, s>>>(p);
    return cudaSuccess;
  }
  if (design == 0) {
    surface_kernel<kLit, kTextured, kColors>
        <<<static_cast<unsigned>((p.rays + kThreads - 1) / kThreads),
           kThreads, shared, s>>>(p);
    return cudaSuccess;
  }
  return design == 2
             ? surface_resident<kLit, kTextured, kColors, true>(p, shared, s)
             : surface_resident<kLit, kTextured, kColors, false>(p, shared,
                                                                 s);
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <bool kVec, bool kGrad>
cudaError_t combine_bwd_resident(const CombineBwdParams& q, size_t shared,
                                 cudaStream_t s) {
  static const Grid grid = resident_grid(
      reinterpret_cast<const void*>(combine_bwd_resident_kernel<kVec, kGrad>),
      kCombineBwdThreads);
  if (grid.err != cudaSuccess) return grid.err;
  const long long blocks =
      (q.f.rays + kCombineBwdThreads - 1) / kCombineBwdThreads;
  combine_bwd_resident_kernel<kVec, kGrad>
      <<<static_cast<unsigned>(std::min(blocks, grid.blocks)),
         kCombineBwdThreads, shared, s>>>(q);
  return cudaSuccess;
}

// The env variant's launch, on its resident grid for `shared` bytes: the
// redesign (combine_bwd_env_warp_kernel), or with `first` its first design.
template <bool kVec, bool kGrad>
cudaError_t combine_bwd_env(const CombineBwdParams& q, bool first,
                            size_t shared, cudaStream_t s) {
  const void* kernel =
      first ? reinterpret_cast<const void*>(combine_bwd_env_kernel<kVec, kGrad>)
            : reinterpret_cast<const void*>(
                  combine_bwd_env_warp_kernel<kVec, kGrad>);
  const Grid grid = sized_grid(kernel, kCombineBwdThreads, shared);
  if (grid.err != cudaSuccess) return grid.err;
  const long long blocks =
      (q.f.rays + kCombineBwdThreads - 1) / kCombineBwdThreads;
  const unsigned g = static_cast<unsigned>(std::min(blocks, grid.blocks));
  if (first)
    combine_bwd_env_kernel<kVec, kGrad>
        <<<g, kCombineBwdThreads, shared, s>>>(q);
  else
    combine_bwd_env_warp_kernel<kVec, kGrad>
        <<<g, kCombineBwdThreads, shared, s>>>(q);
  return cudaSuccess;
}

// A combine backward launch of any design (vrt_shade_combine_bwd's), the
// light variant's where kGrad, the env variant's (the resident redesign
// alone; with `first_env` the env variant's first design) where env.
template <bool kGrad>
cudaError_t combine_bwd_launch(const CombineBwdParams& q, int design,
                               bool env, bool first_env, size_t shared,
                               cudaStream_t s) {
  if (design == 0) {
    combine_bwd_kernel<kGrad>
        <<<static_cast<unsigned>((q.f.rays + kThreads - 1) / kThreads),
           kThreads, shared, s>>>(q);
    return cudaSuccess;
  }
  if (env)
    return design == 2
               ? combine_bwd_env<true, kGrad>(q, first_env, shared, s)
               : combine_bwd_env<false, kGrad>(q, first_env, shared, s);
  return design == 2 ? combine_bwd_resident<true, kGrad>(q, shared, s)
                     : combine_bwd_resident<false, kGrad>(q, shared, s);
}

}  // namespace

// The surface kernel.  ptrs (host array of device pointers): o_w, d_w, t,
// n_obj, hit, cell, inst; inst_volume, inst_pos, inst_rot, inst_scale; n,
// cell_size, extends, tint, roughness, metallic, k, tex_scale, albedo_tex,
// normal_tex, rm_tex; textures, tex_sizes, colors; the 15 light pointers in
// the order of Lights; then the outputs albedo, shadow_origin, n_w,
// roughness, metallic, k, refl_dir, gate, shadow_tmax, shadow_dir.  ints:
// instances, volumes, textures, texture height and width, colour cells a
// side, the colour layout (0 packed f32, 1 packed bf16, 2 the unpacked f32
// voxel grid), lit, textured, per-voxel colours, bounce, shadows,
// point lights, spot lights, then the design (0: the first, one thread a ray
// over the whole grid; 1: the redesign, resident blocks, lane by lane; 2:
// the redesign on the vector path, which takes o_w, d_w, n_obj, hit, albedo,
// shadow_origin, n_w, refl_dir and every shadow direction row on 16-byte
// boundaries; 3: surface_voxels_kernel, on the unpacked voxel grid alone).
// Returns cudaGetLastError().
extern "C" int vrt_shade_surface(const void* const* ptrs, const int* ints,
                                 long long rays, void* stream) {
  const int n_inst = ints[0], n_vol = ints[1], n_tex = ints[2];
  const bool lit = ints[7], textured = ints[8], colors = ints[9];
  const int points = ints[12], spots = ints[13], design = ints[14];
  if (n_inst < 1 || n_vol < 1 || points < 0 || points > kMaxLights ||
      spots < 0 || spots > kMaxLights || design < 0 || design > 3 ||
      ints[6] < 0 || ints[6] > 2)
    return cudaErrorInvalidValue;
  SurfaceParams p;
  surface_inputs(ptrs, ints, rays, p);
  if (design == 3 && (!colors || !p.colors_unpacked || p.colors == nullptr))
    return cudaErrorInvalidValue;
  p.lights = lights_from(ptrs, 25, points, spots);
  const int out = 25 + kLightPtrs;
  p.albedo = const_cast<float*>(at<float>(ptrs, out));
  p.shadow_origin = const_cast<float*>(at<float>(ptrs, out + 1));
  p.n_w = const_cast<float*>(at<float>(ptrs, out + 2));
  p.roughness = const_cast<float*>(at<float>(ptrs, out + 3));
  p.metallic = const_cast<float*>(at<float>(ptrs, out + 4));
  p.k = const_cast<float*>(at<float>(ptrs, out + 5));
  p.refl_dir = const_cast<float*>(at<float>(ptrs, out + 6));
  p.gate = const_cast<uint8_t*>(at<uint8_t>(ptrs, out + 7));
  p.shadow_tmax = const_cast<float*>(at<float>(ptrs, out + 8));
  p.shadow_dir = const_cast<float*>(at<float>(ptrs, out + 9));
  if (design == 2) {
    for (const void* x : {static_cast<const void*>(p.o_w),
                          static_cast<const void*>(p.d_w),
                          static_cast<const void*>(p.n_obj),
                          static_cast<const void*>(p.hit),
                          static_cast<const void*>(p.albedo),
                          static_cast<const void*>(p.shadow_origin),
                          static_cast<const void*>(p.n_w),
                          static_cast<const void*>(p.refl_dir)})
      if (!aligned16(x)) return cudaErrorInvalidValue;
    if (p.shadow_dir != nullptr)
      for (int j = 0; j < points + spots; ++j)
        if (!aligned16(p.shadow_dir + 3 * j * rays))
          return cudaErrorInvalidValue;
  }

  const size_t shared =
      4 * (static_cast<size_t>(n_inst) * kInstRow + n_vol * kVolRow +
           2 * n_tex + 4 + points * kPointRow + spots * kSpotRow);
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lit) {
    if (textured) {
      if (colors) err = surface_launch<true, true, true>(p, design, shared, s);
      else err = surface_launch<true, true, false>(p, design, shared, s);
    } else {
      if (colors) err = surface_launch<true, false, true>(p, design, shared, s);
      else err = surface_launch<true, false, false>(p, design, shared, s);
    }
  } else {
    if (textured) {
      if (colors) err = surface_launch<false, true, true>(p, design, shared, s);
      else err = surface_launch<false, true, false>(p, design, shared, s);
    } else {
      if (colors) err = surface_launch<false, false, true>(p, design, shared, s);
      else err = surface_launch<false, false, false>(p, design, shared, s);
    }
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The combine kernel.  ptrs: d_w, n_obj, hit, unlit; albedo, shadow_origin,
// n_w, roughness, metallic, k, refl_dir, refl_rgb; 11 blocked pointers (the
// directional light's, the point lights', the spot lights'; null where no
// shadow was traced); the 15 light pointers in the order of Lights; env;
// out.  ints: lit, final, point lights, spot lights, env cube side, then the
// design as vrt_shade_surface takes it (the vector path takes d_w, hit,
// unlit and out on 16-byte boundaries).  Returns cudaGetLastError().
extern "C" int vrt_shade_combine(const void* const* ptrs, const int* ints,
                                 long long rays, void* stream) {
  const int points = ints[2], spots = ints[3], design = ints[5];
  if (points < 0 || points > kMaxLights || spots < 0 || spots > kMaxLights ||
      ints[4] < 1 || design < 0 || design > 2)
    return cudaErrorInvalidValue;
  CombineParams p;
  combine_inputs(ptrs, ints, rays, p);
  p.out = const_cast<float*>(at<float>(ptrs, 13 + kMaxBlocked + kLightPtrs));
  if (design == 2)
    for (const void* x : {static_cast<const void*>(p.d_w),
                          static_cast<const void*>(p.hit),
                          static_cast<const void*>(p.unlit),
                          static_cast<const void*>(p.out)})
      if (!aligned16(x)) return cudaErrorInvalidValue;
  const size_t shared = 4 * (4 + points * kPointRow + spots * kSpotRow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (design == 0)
    combine_kernel<<<static_cast<unsigned>((rays + kThreads - 1) / kThreads),
                     kThreads, shared, s>>>(p);
  else if (design == 2)
    err = combine_resident<true>(p, shared, s);
  else
    err = combine_resident<false>(p, shared, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The surface kernel's backward.  ptrs: the surface kernel's first 25
// (o_w ... colors); the cotangents of albedo, shadow_origin, n_w, roughness,
// metallic and refl_dir (null for zero); then the outputs g_o_w, g_d_w
// (null, both, when not asked), g_t, g_n_obj and g_colors (an f32
// accumulator, [V*cn^3, 24] for a packed table and [V*cn^3, 3] for the
// voxel grid, zeroed by the caller and added into; null when not asked);
// then the material variant's cotangent of the record's k [R] (null for
// zero) and its accumulator of the material constants, [V,8] f32 (tint 4,
// roughness, metallic, k, padding; zeroed by the caller and added into;
// null but in the material variant); then the texture variant's
// accumulators of the texture scale [V,2] and of the stacked textures
// [T,TH,TW,3], f32 (zeroed by the caller and added into; null but in the
// texture variant); then the instance variant's accumulator of the instance
// transforms' cotangents [I, kInstanceWords] f32 (zeroed by the caller and
// added into; null but in the instance variant): kSurfaceBwdPtrs pointers.
// ints: the surface kernel's 14, then the design (0: the first, one thread
// a ray over the whole grid; 1: the merged kernel, resident blocks striding
// over the rays), then 1 for the material variant, else 0, then 1 for the
// texture variant (the merged kernel in a textured mode alone; with the
// material variant, one launch of both), else 0, then 1 for the instance
// variant (the merged kernel alone; with the material and the texture
// variant, one launch of all), else 0, then 1 for the texture variant's
// first design (surface_bwd_textures_kernel, the comparator of the
// redesign, which the texture variant launches otherwise; not with the
// instance variant, whose texture path is the redesign's), else 0, then 1
// for the material and instance variants' first design (the merged
// kernel's kMat instantiation, surface_bwd_instances_kernel: the
// comparators of surface_bwd_sums_kernel, which the material variant
// without the texture variant and the instance variant launch otherwise),
// else 0: kSurfaceBwdInts ints.  The texture
// variant sums the textures' cotangents in shared memory where the stack's
// f32 words fit kTexSharedBytes.  The merged kernel takes outputs on
// 16-byte boundaries.  New slots go last, so that a caller's arrays also
// drive a library built before them.  Returns cudaGetLastError().
constexpr int kSurfaceBwdPtrs = 41, kSurfaceBwdInts = 20;
extern "C" int vrt_shade_surface_bwd(const void* const* ptrs, const int* ints,
                                     long long rays, void* stream) {
  const int n_inst = ints[0], n_vol = ints[1], n_tex = ints[2];
  const bool lit = ints[7], textured = ints[8], colors = ints[9];
  const bool merged = ints[14] != 0, material = ints[15] != 0;
  const bool textures = ints[16] != 0, instances = ints[17] != 0;
  const bool first_tex = ints[18] != 0, first_sums = ints[19] != 0;
  // the launches the sums' redesign (or with first_sums its first design)
  // takes: the instance variant, the material variant without the texture
  // variant
  const bool sums = merged && (instances || (material && !textures));
  if (n_inst < 1 || n_vol < 1 || ints[6] < 0 || ints[6] > 2 ||
      (textures && !(merged && textured)) || (instances && !merged) ||
      (first_tex && (!textures || instances)) || (first_sums && !sums))
    return cudaErrorInvalidValue;
  SurfaceBwdParams q;
  surface_inputs(ptrs, ints, rays, q.f);
  q.g_albedo = at<float>(ptrs, 25);
  q.g_shadow_origin = at<float>(ptrs, 26);
  q.g_n_w = at<float>(ptrs, 27);
  q.g_roughness = at<float>(ptrs, 28);
  q.g_metallic = at<float>(ptrs, 29);
  q.g_refl_dir = at<float>(ptrs, 30);
  q.g_o_w = const_cast<float*>(at<float>(ptrs, 31));
  q.g_d_w = const_cast<float*>(at<float>(ptrs, 32));
  q.g_t = const_cast<float*>(at<float>(ptrs, 33));
  q.g_n_obj = const_cast<float*>(at<float>(ptrs, 34));
  q.g_colors = const_cast<float*>(at<float>(ptrs, 35));
  q.g_k = at<float>(ptrs, 36);
  q.g_mat = const_cast<float*>(at<float>(ptrs, 37));
  q.g_tex_scale = const_cast<float*>(at<float>(ptrs, 38));
  q.g_textures = const_cast<float*>(at<float>(ptrs, 39));
  q.g_inst = const_cast<float*>(at<float>(ptrs, kSurfaceBwdPtrs - 1));
  if ((q.g_o_w == nullptr) != (q.g_d_w == nullptr) || q.g_t == nullptr ||
      q.g_n_obj == nullptr || (material && q.g_mat == nullptr) ||
      (textures && (q.g_tex_scale == nullptr || q.g_textures == nullptr)) ||
      (instances && q.g_inst == nullptr))
    return cudaErrorInvalidValue;
  const long long tex_words =
      static_cast<long long>(n_tex) * q.f.tex_h * q.f.tex_w * 3;
  q.tex_shared = textures && 4 * tex_words <= kTexSharedBytes;
  if (merged)
    for (const float* out : {q.g_o_w, q.g_d_w, q.g_t, q.g_n_obj})
      if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return cudaErrorInvalidValue;
  // the staged tables, and with the material variant the block's partial
  // sums of the material constants' cotangents after them, then the texture
  // variant's of the texture scale and (on the shared path) the textures,
  // then the instance variant's of the instance transforms
  const size_t tables =
      4 * (static_cast<size_t>(n_inst) * kInstRow + n_vol * kVolRow +
           2 * n_tex + (textures ? n_vol * kTexScaleRow : 0) +
           (q.tex_shared ? tex_words : 0));
  const size_t shared =
      tables + 4 * ((material ? static_cast<size_t>(n_vol) * kMatRow : 0) +
                    (instances ? n_inst * kInstanceWords : 0));
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (rays + kThreads - 1) / kThreads;
  cudaError_t err = cudaSuccess;
#define VRT_SURFACE_BWD_DESIGN(L, T, C, M)                                  \
  do {                                                                      \
    if (!merged) {                                                          \
      surface_bwd_kernel<L, T, C, M>                                        \
          <<<static_cast<unsigned>(blocks), kThreads, shared, s>>>(q);      \
      break;                                                                \
    }                                                                       \
    const Grid g = merged_grid<L, T, C, M>();                               \
    err = g.err;                                                            \
    if (err == cudaSuccess)                                                 \
      surface_bwd_merged_kernel<L, T, C, M>                                 \
          <<<static_cast<unsigned>(std::min(blocks, g.blocks)), kThreads,   \
             shared, s>>>(q);                                               \
  } while (0)
#define VRT_SURFACE_BWD(L, T, C)                                            \
  do {                                                                      \
    if (material) VRT_SURFACE_BWD_DESIGN(L, T, C, true);                    \
    else VRT_SURFACE_BWD_DESIGN(L, T, C, false);                            \
  } while (0)
  // the texture variant: a textured mode, the merged kernel
#define VRT_SURFACE_BWD_TEX(L, C)                                           \
  do {                                                                      \
    if (textures) {                                                         \
      err = material                                                        \
                ? surface_bwd_textures<L, C, true>(q, first_tex, blocks,    \
                                                   shared, s)               \
                : surface_bwd_textures<L, C, false>(q, first_tex, blocks,   \
                                                    shared, s);             \
      break;                                                                \
    }                                                                       \
    VRT_SURFACE_BWD(L, true, C);                                            \
  } while (0)
#define VRT_SURFACE_BWD_SUMS(L, T, C)                                       \
  surface_bwd_sums<L, T, C>(q, material, textures, instances, first_sums,  \
                            blocks, shared, tables, s)
  if (sums) {
    if (lit) {
      if (textured)
        err = colors ? VRT_SURFACE_BWD_SUMS(true, true, true)
                     : VRT_SURFACE_BWD_SUMS(true, true, false);
      else
        err = colors ? VRT_SURFACE_BWD_SUMS(true, false, true)
                     : VRT_SURFACE_BWD_SUMS(true, false, false);
    } else {
      if (textured)
        err = colors ? VRT_SURFACE_BWD_SUMS(false, true, true)
                     : VRT_SURFACE_BWD_SUMS(false, true, false);
      else
        err = colors ? VRT_SURFACE_BWD_SUMS(false, false, true)
                     : VRT_SURFACE_BWD_SUMS(false, false, false);
    }
  } else if (lit) {
    if (textured) {
      if (colors) VRT_SURFACE_BWD_TEX(true, true);
      else VRT_SURFACE_BWD_TEX(true, false);
    } else {
      if (colors) VRT_SURFACE_BWD(true, false, true);
      else VRT_SURFACE_BWD(true, false, false);
    }
  } else {
    if (textured) {
      if (colors) VRT_SURFACE_BWD_TEX(false, true);
      else VRT_SURFACE_BWD_TEX(false, false);
    } else {
      if (colors) VRT_SURFACE_BWD(false, false, true);
      else VRT_SURFACE_BWD(false, false, false);
    }
  }
#undef VRT_SURFACE_BWD_SUMS
#undef VRT_SURFACE_BWD_TEX
#undef VRT_SURFACE_BWD
#undef VRT_SURFACE_BWD_DESIGN
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The combine kernel's backward.  ptrs: the combine kernel's first 39
// (d_w ... env); g_rgb [R,3]; then the outputs g_albedo, g_shadow_origin,
// g_n_w, g_roughness, g_metallic, g_refl_dir, g_d_w, g_n_obj, g_refl_rgb,
// each null where nobody needs it; then the light variant's g_k [R] (null
// unlit) and its accumulator of the light tables (129 floats,
// zeroed by the caller and added into; null but in the light variant);
// then the env variant's accumulator of the env cube [6,E,E,3] f32 (zeroed
// by the caller and added into; null but in the env variant):
// kCombineBwdPtrs pointers.  ints: the combine kernel's (final is not
// read), then the design (0: the first, one thread a ray over the whole
// grid; 1: the redesign, resident blocks, lane by lane; 2: the redesign on
// the vector path, which takes d_w, g_rgb, hit, unlit, every [R,3] record
// input passed and every [R,3] output on 16-byte boundaries), then 1 for
// the light variant, else 0, then 1 for the env variant (the redesign
// alone; with the light variant, one launch of both), else 0, then 1 for
// the env variant's first design (combine_bwd_env_kernel, the comparator of
// combine_bwd_env_warp_kernel, which the env variant launches otherwise),
// else 0: kCombineBwdInts ints.  The env variant sums the cube's
// cotangents in shared memory where its f32 words fit kEnvSharedBytes.
// Returns cudaGetLastError().
constexpr int kCombineBwdPtrs = 52, kCombineBwdInts = 9;
extern "C" int vrt_shade_combine_bwd(const void* const* ptrs, const int* ints,
                                     long long rays, void* stream) {
  const int points = ints[2], spots = ints[3], design = ints[5];
  const bool lights = ints[6] != 0, env = ints[7] != 0;
  const bool first_env = ints[8] != 0;
  if (points < 0 || points > kMaxLights || spots < 0 || spots > kMaxLights ||
      ints[4] < 1 || design < 0 || design > 2 || (env && design == 0) ||
      (first_env && !env))
    return cudaErrorInvalidValue;
  CombineBwdParams q;
  combine_inputs(ptrs, ints, rays, q.f);
  const int g = 13 + kMaxBlocked + kLightPtrs;
  q.g_rgb = at<float>(ptrs, g);
  float* outs[9];
  for (int j = 0; j < 9; ++j) outs[j] = const_cast<float*>(at<float>(ptrs, g + 1 + j));
  q.g_albedo = outs[0];
  q.g_shadow_origin = outs[1];
  q.g_n_w = outs[2];
  q.g_roughness = outs[3];
  q.g_metallic = outs[4];
  q.g_refl_dir = outs[5];
  q.g_d_w = outs[6];
  q.g_n_obj = outs[7];
  q.g_refl_rgb = outs[8];
  q.g_k = const_cast<float*>(at<float>(ptrs, g + 10));
  q.g_lights = const_cast<float*>(at<float>(ptrs, g + 11));
  q.g_env = const_cast<float*>(at<float>(ptrs, kCombineBwdPtrs - 1));
  if ((lights && (q.g_lights == nullptr || (q.f.lit && q.g_k == nullptr))) ||
      (env && q.g_env == nullptr))
    return cudaErrorInvalidValue;
  const long long env_words = 18ll * q.f.env_side * q.f.env_side;
  q.env_shared = env && 4 * env_words <= kEnvSharedBytes;
  if (design == 2)
    for (const void* x : {static_cast<const void*>(q.f.d_w),
                          static_cast<const void*>(q.g_rgb),
                          static_cast<const void*>(q.f.hit),
                          static_cast<const void*>(q.f.unlit),
                          static_cast<const void*>(q.f.albedo),
                          static_cast<const void*>(q.f.shadow_origin),
                          static_cast<const void*>(q.f.n_w),
                          static_cast<const void*>(q.f.refl_dir),
                          static_cast<const void*>(q.f.refl_rgb),
                          static_cast<const void*>(q.g_albedo),
                          static_cast<const void*>(q.g_shadow_origin),
                          static_cast<const void*>(q.g_n_w),
                          static_cast<const void*>(q.g_refl_dir),
                          static_cast<const void*>(q.g_d_w),
                          static_cast<const void*>(q.g_n_obj),
                          static_cast<const void*>(q.g_refl_rgb)})
      if (x != nullptr && !aligned16(x)) return cudaErrorInvalidValue;
  // the staged lights, and with the light variant the block's partial sums
  // of their cotangents beside them, then the env variant's of the env cube
  // on the shared path
  const size_t shared =
      4 * ((4 + points * kPointRow + spots * kSpotRow) * (lights ? 2 : 1) +
           (q.env_shared ? env_words : 0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lights ? combine_bwd_launch<true>(q, design, env, first_env, shared, s)
             : combine_bwd_launch<false>(q, design, env, first_env, shared,
                                         s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The probe's census of the texture and env variants' merges (a build with
// kTapCensus alone counts): copies the 33 counts (merges with k distinct
// keys among the lanes that add, k = 0..32) into the host array `out` and,
// where `reset`, zeroes them.  Returns the copies' error.
extern "C" int vrt_shade_tap_census(void* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_tap_census,
                                       sizeof(g_tap_census));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[33] = {};
    e = cudaMemcpyToSymbol(g_tap_census, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
