// K1 — the voxel march, one thread per ray lane, for Hopper (sm_90a).
//
// Replaces the retired Pallas TPU kernel scripts/pallas_march.py::_kernel
// and the XLA while-loop vrt/march/march.py::_march_core (_march_begin ->
// _march_run -> _march_finish), in interp and cube mode and with the debug
// overlay.  It computes what vrt_torch.march.march.march_lanes_reference
// computes, lane for lane: per-lane volume ids over stacked volumes, octree
// or chebyshev skip nodes, f32 or bf16 corner tables of 8 or 9 channels
// (the first 8 are read), the slab entry with its +0.01 bias and the
// ReverseRay no-op branch, <= 255 node steps with the +0.1 exit bias, and
// the red exhausted hit at t = 10.  Interp mode adds the solid-entry
// report and the trilinear cubic with its bracketed root on surface cells;
// cube mode instead hits the first voxel of density <= 0 (read from the f32
// voxel table, N = C + 1 per axis) at its node-entry t, with the face
// normal of the last crossing.  The overlay reports node-border hits.  The
// three choices are template flags, so each variant compiles on its own.
//
// What bounds it: each step is a chain of dependent random reads — the
// 1-byte accel value of the current cell, then on surface cells its 16 or
// 32-byte corner row (in cube mode one 4-byte density) — from tables larger
// than the 50 MB L2 at the flagship size (2 x 128^3 cells: 4 MB of accel,
// 67 MB of bf16 corners, 17 MB of f32 densities).  So it is latency-bound,
// not bandwidth- or FLOP-bound.
//
// This first version stays simple: one thread per ray with no shared
// memory, __ldg row loads, and every lane retiring on its own (lane
// activity only decreases, so this equals the reference's shared loop).
// It is built with --fmad=false so that every operation rounds like the
// eager twin; sums run in the twin's order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxIterations = 255;
constexpr float kExhaustedT = 10.0f;
constexpr int kKindSurface = 1;
constexpr int kKindSolidEntry = 2;
constexpr int kKindExhausted = 3;
constexpr int kKindCube = 4;
constexpr int kKindDebug = 5;
constexpr float kLineThickness = 0.5f;

// Corner order (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),(1,0,1),(0,1,1),
// (1,1,1): bit k of the corner index is the offset on axis k.
__device__ __forceinline__ int corner_bit(int i, int k) {
  return (i >> k) & 1;
}

// jnp.sign: NaN stays NaN (a NaN never compares equal or <= 0).
__device__ __forceinline__ float sgn(float x) {
  if (isnan(x)) return x;
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// NaN-propagating max / min (jnp.maximum, jnp.max).
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

__device__ __forceinline__ float eval_cubic(float t, float A, float B,
                                            float C, float D) {
  return ((A * t + B) * t + C) * t + D;
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

struct Params {
  const float* o;          // [L,3]
  const float* d;          // [L,3]
  const float* t_max;      // [L]
  const int32_t* vol_ids;  // [L]
  const int32_t* n;        // [V] voxels per axis
  const float* cell_size;  // [V]
  const float* extends;    // [V]
  const uint8_t* accel;    // [V*C^3] packed, skips clamped to 127
  const void* corners;     // [V*C^3, ch] f32 or bf16
  const float* sdf;        // [V*N^3] voxel densities, N = C + 1
  int cc;                  // C: cells per axis of the padded tables
  int ch;                  // corner-table channels, 8 or 9
  long long lanes;
  uint8_t* hit;
  float* t;
  int32_t* kind;
  int32_t* cell;
  float* t_in;
  float* t_out;
  float* face;
  int32_t* steps;
};

struct Lane {
  float o[3], d[3], inv[3];
  float h, ext;
  int n;
};

// Skip-node box of a cell: valid, has_surface, lo, hi.
template <bool kCheb>
__device__ __forceinline__ bool node_box(const Lane& L, const int c[3],
                                         int av, bool* has_surf,
                                         float lo[3], float hi[3]) {
  const bool valid = c[0] >= 0 && c[1] >= 0 && c[2] >= 0 &&
                     c[0] + 1 < L.n && c[1] + 1 < L.n && c[2] + 1 < L.n;
  *has_surf = (av & 1) == 1;
  float size;
  int origin[3];
  if (kCheb) {
    const int half = max((av >> 1) - 1, 0);
    for (int k = 0; k < 3; ++k) origin[k] = c[k] - half;
    size = (2.0f * static_cast<float>(half) + 1.0f) * L.h;
  } else {
    const int level = av >> 1;
    for (int k = 0; k < 3; ++k) origin[k] = (c[k] >> level) << level;
    size = static_cast<float>(1 << level) * L.h;
  }
  for (int k = 0; k < 3; ++k) {
    lo[k] = valid ? static_cast<float>(origin[k]) * L.h - L.ext : -1.0f;
    hi[k] = lo[k] + (valid ? size : 0.0f);
  }
  return valid;
}

// Node exit t and its axis with the reference's nested-if tie-break.
__device__ __forceinline__ float exit_t(const Lane& L, const float lo[3],
                                        const float hi[3], int* axis) {
  float tm[3];
  for (int k = 0; k < 3; ++k) {
    const float sel = L.d[k] > 0.0f ? hi[k] : lo[k];
    tm[k] = L.d[k] != 0.0f ? (sel - L.o[k]) * L.inv[k] : 1e5f;
  }
  if (tm[0] < tm[1]) {
    *axis = tm[0] < tm[2] ? 0 : 2;
    return tm[0] < tm[2] ? tm[0] : tm[2];
  }
  *axis = tm[1] < tm[2] ? 1 : 2;
  return tm[1] < tm[2] ? tm[1] : tm[2];
}

// Box-face normal at pos(t - 0.1): +1 beyond +ext, -1 beyond -ext, else 0,
// then HLSL-normalized (a zero triple gives NaN, as in the reference).
__device__ __forceinline__ void entry_face(const Lane& L, float t,
                                           float n[3]) {
  for (int k = 0; k < 3; ++k) {
    const float rp = L.o[k] + L.d[k] * (t - 0.1f);
    n[k] = sgn(rp - L.ext);
    if (n[k] < 0.0f) n[k] = rp < -L.ext ? -1.0f : 0.0f;
  }
  const float norm = sqrtf((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]);
  for (int k = 0; k < 3; ++k) n[k] = n[k] / norm;
}

// The debug overlay's test: pos lies within kLineThickness of two faces of
// the node box, inside the box grown by kLineThickness.
__device__ __forceinline__ bool hits_node_bounds(const float pos[3],
                                                 const float lo[3],
                                                 const float hi[3]) {
  bool inside = true;
  bool b[3];
  for (int k = 0; k < 3; ++k) {
    inside = inside && pos[k] >= lo[k] - kLineThickness &&
             pos[k] <= hi[k] + kLineThickness;
    b[k] = fabsf(pos[k] - lo[k]) <= kLineThickness ||
           fabsf(pos[k] - hi[k]) <= kLineThickness;
  }
  return inside && (((b[0] || b[1]) && b[2]) || ((b[1] || b[2]) && b[0]));
}

__device__ __forceinline__ void pos_to_cell(const Lane& L, const float p[3],
                                            int c[3]) {
  for (int k = 0; k < 3; ++k)
    c[k] = static_cast<int>(floorf((p[k] + L.ext) / L.h));
}

// Regula-falsi / secant root of the cubic on [t_in, t_out].
__device__ bool surface_intersection(float A, float B, float C, float D,
                                     float t_in, float t_out, float* t_hit) {
  float t0 = nmax(0.0f, -t_in / (t_out - t_in));
  float t1 = 1.0f;
  float f0 = eval_cubic(t0, A, B, C, D);
  const bool immediate = sgn(f0) <= 0.0f;
  float f1 = eval_cubic(t1, A, B, C, D);

  const float dA = 3.0f * A;
  const float dB = 2.0f * B;
  const float disc = dB * dB - 4.0f * dA * C;
  const float sq = sqrtf(nmax(disc, 0.0f));
  const bool safe = (disc >= 0.0f) && (dA != 0.0f);
  const float denom = dA != 0.0f ? 2.0f * dA : 1.0f;
  const float ex1 = safe ? (-dB + sq) / denom : INFINITY;
  const float ex2 = safe ? (-dB - sq) / denom : INFINITY;
  const float ex[2] = {nmin(ex1, ex2), nmax(ex1, ex2)};
  for (int j = 0; j < 2; ++j) {
    const bool inside = (ex[j] >= t0) && (ex[j] <= t1);
    const float fe = eval_cubic(ex[j], A, B, C, D);
    const bool same = sgn(fe) == sgn(f0);
    if (inside && same) {
      t0 = ex[j];
      f0 = fe;
    } else if (inside) {
      t1 = ex[j];
      f1 = fe;
    }
  }
  const bool no_hit = sgn(f0) == sgn(f1);
  for (int j = 0; j < 2; ++j) {
    const float t = t0 + (t1 - t0) * (-f0 / (f1 - f0));
    const float f = eval_cubic(t, A, B, C, D);
    if (sgn(f) == sgn(f0)) {
      t0 = t;
      f0 = f;
    } else {
      t1 = t;
      f1 = f;
    }
  }
  const float tau = t0 + (t1 - t0) * (-f0 / (f1 - f0));
  const float t_root = t_in + (t_out - t_in) * tau;
  *t_hit = immediate ? t_in : t_root;
  return immediate || (!no_hit && *t_hit > 0.0f);
}

template <typename T, bool kCheb, bool kInterp, bool kDebug>
__global__ void __launch_bounds__(256) march_kernel(const Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.lanes) return;

  Lane L;
  for (int k = 0; k < 3; ++k) {
    L.o[k] = p.o[3 * i + k];
    L.d[k] = p.d[3 * i + k];
    L.inv[k] = L.d[k] != 0.0f ? 1.0f / L.d[k] : -INFINITY;
  }
  const float t_max = p.t_max[i];
  const int v = p.vol_ids[i];
  L.n = p.n[v];
  L.h = p.cell_size[v];
  L.ext = p.extends[v];
  const long long cc = p.cc;
  const long long vol_base = static_cast<long long>(v) * cc * cc * cc;
  const uint8_t* accel = p.accel + vol_base;
  const T* corners = static_cast<const T*>(p.corners) + vol_base * p.ch;
  const long long nn = cc + 1;
  const float* sdf = p.sdf + static_cast<long long>(v) * nn * nn * nn;

  // accel / corner reads of a cell; out-of-range cells read 0
  auto accel_at = [&](const int c[3]) -> int {
    if (c[0] < 0 || c[1] < 0 || c[2] < 0 || c[0] >= L.n - 1 ||
        c[1] >= L.n - 1 || c[2] >= L.n - 1)
      return 0;
    return __ldg(accel + (c[0] * cc + c[1]) * cc + c[2]);
  };
  auto corners_at = [&](const int c[3], float v8[8]) {
    const bool valid = c[0] >= 0 && c[1] >= 0 && c[2] >= 0 &&
                       c[0] + 1 < L.n && c[1] + 1 < L.n && c[2] + 1 < L.n;
    const T* row = corners + ((c[0] * cc + c[1]) * cc + c[2]) * p.ch;
    for (int j = 0; j < 8; ++j) v8[j] = valid ? load_corner<T>(row + j) : 0.0f;
  };
  // cube mode's voxel density; out-of-range voxels read 0
  auto density_at = [&](const int c[3]) -> float {
    if (c[0] < 0 || c[1] < 0 || c[2] < 0 || c[0] >= L.n || c[1] >= L.n ||
        c[2] >= L.n)
      return 0.0f;
    return __ldg(sdf + (c[0] * nn + c[1]) * nn + c[2]);
  };

  // ---- slab entry (_march_begin) -----------------------------------------
  float t_enter = 0.0f, t_exit = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float s_min = L.d[k] > 0.0f ? -L.ext : L.ext;
    const float s_max = L.d[k] > 0.0f ? L.ext : -L.ext;
    const float a = (s_min - L.o[k]) * L.inv[k];
    const float b = (s_max - L.o[k]) * L.inv[k];
    t_enter = k == 0 ? a : nmax(t_enter, a);
    t_exit = k == 0 ? b : nmin(t_exit, b);
  }
  const bool ok = (t_exit > t_enter) && (t_exit >= 0.0f) && (t_enter <= t_max);
  const bool pos_branch = t_enter >= 0.0f;
  const float t_enter_b = pos_branch ? t_enter + 0.01f : t_enter;
  int cell[3];
  {
    float pos[3];
    for (int k = 0; k < 3; ++k)
      pos[k] = pos_branch ? L.o[k] + L.d[k] * t_enter_b : L.o[k];
    pos_to_cell(L, pos, cell);
  }
  float lo[3], hi[3];
  bool has_surf;
  int axis;
  const bool valid0 = node_box<kCheb>(L, cell, accel_at(cell), &has_surf,
                                      lo, hi);
  float cell_exit = pos_branch ? t_enter_b : -exit_t(L, lo, hi, &axis) + 0.01f;

  // the no-hit result, derived from the origin as the reference derives it
  const float zf = L.o[0] * 0.0f;
  bool hit = false;
  float t_best = zf + INFINITY;
  int kind = 0;
  int cell_best[3] = {0, 0, 0};
  float t_in_best = zf, t_out_best = zf;
  float face[3] = {L.o[0] * 0.0f, L.o[1] * 0.0f, L.o[2] * 0.0f};

  bool active = ok;
  // cube mode: the face normal of the last crossing, seeded with the entry
  // face (vrt's where(pos_branch, t_enter_b, t_enter) is t_enter_b)
  float cur_face[3] = {0.0f, 0.0f, 0.0f};
  if (!kInterp) entry_face(L, t_enter_b, cur_face);
  if (kInterp && ok) {
    float v8[8];
    corners_at(cell, v8);
    bool solid = valid0;
    for (int j = 0; j < 8; ++j) solid = solid && v8[j] < 0.0f;
    if (solid) {
      active = false;
      if (t_enter_b >= 0.0f && t_enter_b <= t_max) {
        hit = true;
        t_best = t_enter_b;
        kind = kKindSolidEntry;
        entry_face(L, t_enter_b, face);
        for (int k = 0; k < 3; ++k) cell_best[k] = cell[k];
      }
    }
  }

  // ---- node steps (_march_run) -------------------------------------------
  int steps = 0;
  for (int it = 0; it < kMaxIterations && active; ++it) {
    ++steps;
    if (cell_exit > t_exit) {
      active = false;
      break;
    }
    const float cell_enter = cell_exit;
    const bool valid_cell = node_box<kCheb>(L, cell, accel_at(cell),
                                            &has_surf, lo, hi);
    const bool valid =
        kInterp ? valid_cell
                : (cell[0] >= 0 && cell[1] >= 0 && cell[2] >= 0 &&
                   cell[0] < L.n && cell[1] < L.n && cell[2] < L.n);
    if (kDebug && valid) {
      float pos[3];
      for (int k = 0; k < 3; ++k) pos[k] = L.o[k] + L.d[k] * cell_enter;
      if (hits_node_bounds(pos, lo, hi)) {
        if (cell_enter >= 0.0f && cell_enter <= t_max) {
          hit = true;
          t_best = cell_enter;
          kind = kKindDebug;
        }
        active = false;
        break;
      }
    }
    const float new_exit = exit_t(L, lo, hi, &axis) + 0.1f;
    if (!kInterp) {
      if (valid && density_at(cell) <= 0.0f) {
        if (cell_enter >= 0.0f && cell_enter <= t_max) {
          hit = true;
          t_best = cell_enter;
          kind = kKindCube;
          for (int k = 0; k < 3; ++k) {
            cell_best[k] = cell[k];
            face[k] = cur_face[k];
          }
        }
        active = false;
        break;
      }
      // the face normal of the crossing about to be taken
      for (int k = 0; k < 3; ++k)
        cur_face[k] = -sgn(L.d[k]) * (k == axis ? 1.0f : 0.0f);
    } else if (valid && has_surf) {
      // surface nodes are single cells: the x-extent is the cell size
      const float size = hi[0] - lo[0];
      float a1[3], b1[3];
      for (int k = 0; k < 3; ++k) {
        const float p_in = L.o[k] + L.d[k] * cell_enter;
        const float p_out = L.o[k] + L.d[k] * new_exit;
        const float base = static_cast<float>(cell[k]) * L.h - L.ext;
        a1[k] = (p_in - base) / size;
        b1[k] = (p_out - base) / size - a1[k];
      }
      float v8[8];
      corners_at(cell, v8);
      float pa[8], pb[8], pB[8], pC[8];
      for (int j = 0; j < 8; ++j) {
        float x[3], u[3];
        for (int k = 0; k < 3; ++k) {
          x[k] = corner_bit(j, k) ? a1[k] : 1.0f - a1[k];
          u[k] = corner_bit(j, k) ? b1[k] : -b1[k];
        }
        pa[j] = ((x[0] * x[1]) * x[2]) * v8[j];
        pb[j] = ((u[0] * u[1]) * u[2]) * v8[j];
        pB[j] = ((x[0] * (u[1] * u[2]) + x[1] * (u[0] * u[2])) +
                 x[2] * (u[0] * u[1])) * v8[j];
        pC[j] = ((u[0] * (x[1] * x[2]) + u[1] * (x[0] * x[2])) +
                 u[2] * (x[0] * x[1])) * v8[j];
      }
      float t_hit;
      if (surface_intersection(sum8(pb), sum8(pB), sum8(pC), sum8(pa),
                               cell_enter, new_exit, &t_hit)) {
        if (t_hit >= 0.0f && t_hit <= t_max) {
          hit = true;
          t_best = t_hit;
          kind = kKindSurface;
          for (int k = 0; k < 3; ++k) cell_best[k] = cell[k];
          t_in_best = cell_enter;
          t_out_best = new_exit;
        }
        active = false;
        break;
      }
    }
    if (!valid) {
      active = false;
      break;
    }
    float pos[3];
    for (int k = 0; k < 3; ++k) pos[k] = L.o[k] + L.d[k] * new_exit;
    pos_to_cell(L, pos, cell);
    cell_exit = new_exit;
  }

  // ---- exhausted lanes (_march_finish) -----------------------------------
  if (active && kExhaustedT <= t_max) {
    hit = true;
    t_best = kExhaustedT;
    kind = kKindExhausted;
    face[0] = 1.0f;
    face[1] = 0.0f;
    face[2] = 0.0f;
  }

  p.hit[i] = hit ? 1 : 0;
  p.t[i] = t_best;
  p.kind[i] = kind;
  p.t_in[i] = t_in_best;
  p.t_out[i] = t_out_best;
  p.steps[i] = steps;
  for (int k = 0; k < 3; ++k) {
    p.cell[3 * i + k] = cell_best[k];
    p.face[3 * i + k] = face[k];
  }
}

template <typename T, bool kCheb, bool kInterp, bool kDebug>
void launch(const Params& p, cudaStream_t stream) {
  const int block = 256;
  const long long grid = (p.lanes + block - 1) / block;
  march_kernel<T, kCheb, kInterp, kDebug>
      <<<static_cast<unsigned>(grid), block, 0, stream>>>(p);
}

template <typename T, bool kCheb>
void launch_mode(const Params& p, int interp, int debug, cudaStream_t s) {
  if (interp) {
    if (debug) launch<T, kCheb, true, true>(p, s);
    else launch<T, kCheb, true, false>(p, s);
  } else {
    if (debug) launch<T, kCheb, false, true>(p, s);
    else launch<T, kCheb, false, false>(p, s);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vrt_march_lanes(
    const float* o, const float* d, const float* t_max,
    const int32_t* vol_ids, const int32_t* n, const float* cell_size,
    const float* extends, const uint8_t* accel, const void* corners,
    const float* sdf, int cc, int ch, int bf16, int chebyshev, int interp,
    int debug, long long lanes, uint8_t* hit, float* t, int32_t* kind,
    int32_t* cell, float* t_in, float* t_out, float* face, int32_t* steps,
    void* stream) {
  Params p{o,      d,  t_max, vol_ids, n,    cell_size, extends, accel,
           corners, sdf, cc, ch,     lanes, hit,  t,         kind,    cell,
           t_in,   t_out, face, steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (chebyshev) launch_mode<uint16_t, true>(p, interp, debug, s);
    else launch_mode<uint16_t, false>(p, interp, debug, s);
  } else {
    if (chebyshev) launch_mode<float, true>(p, interp, debug, s);
    else launch_mode<float, false>(p, interp, debug, s);
  }
  return static_cast<int>(cudaGetLastError());
}
