// K1 -- the voxel march, for Hopper (sm_90a): one device function that
// marches a ray through one volume, and two kernels around it.
//
// vrt_march_lanes, one thread per ray lane, replaces the retired Pallas TPU
// kernel scripts/pallas_march.py::_kernel and the XLA while-loop
// vrt/march/march.py::_march_core (_march_begin -> _march_run ->
// _march_finish), in interp and cube mode and with the debug overlay.  It
// computes what vrt_torch.march.march.march_lanes_reference computes, lane
// for lane: per-lane volume ids over stacked volumes, octree or chebyshev
// skip nodes, f32 or bf16 corner tables of 8 or 9 channels (the first 8 are
// read), the slab entry with its +0.01 bias and the ReverseRay no-op branch,
// <= 255 node steps with the +0.1 exit bias, and the red exhausted hit at
// t = 10.  Interp mode adds the solid-entry report and the trilinear cubic
// with its bracketed root on surface cells; cube mode instead hits the first
// voxel of density <= 0 (read from the f32 voxel table, N = C + 1 per axis)
// at its node-entry t, with the face normal of the last crossing.  The
// overlay reports node-border hits.  The three choices are template flags,
// so each variant compiles on its own.
//
// vrt_march_scene, one thread per world ray, replaces the XLA loop
// vrt/render/renderer.py::march_scene (no Pallas kernel stands behind it):
// the closest hit over the scene's <= 32 instances.  It computes what
// vrt_torch.render.renderer.march_scene_reference computes with K1 as its
// lane marcher: every instance's world -> object transform and slab test,
// the candidates ordered by entry t (a stable insertion sort, so ties keep
// the lower instance index), then the candidates marched in that order, each
// with its own 255-step budget and its t_max clamped to the best hit so far.
// With kAnyHit (shadow rays) it writes one boolean and stops at the first
// candidate that hits.
//
// What bounds them: each step is a chain of dependent random reads -- the
// 1-byte accel value of the current cell, then on surface cells its 16 or
// 32-byte corner row (in cube mode one 4-byte density) -- from tables larger
// than the 50 MB L2 at the flagship size (2 x 128^3 cells: 4 MB of accel,
// 67 MB of bf16 corners, 17 MB of f32 densities).  So the march itself is
// latency-bound, not bandwidth- or FLOP-bound.  Around it a launch moves 32 B
// in and 45 B out per lane (28 B in and 49 B out per ray for the scene
// march), 160 MB at 1920x1080: 0.048 ms at 3.35 TB/s before any table byte.
// What the per-lane kernel cost at its boundary was larger than either: one
// launch per candidate instance, each paying those bytes again, between them
// [I,R,3] stacks of object-space rays, a stable sort over [I,R] and per-pass
// gathers and selects in eager PyTorch (28 ms of sorts per 1080p frame).
//
// What the design does about it: the candidate loop runs inside the thread.
// Keys and candidate order live in a 32-entry per-thread array, the
// object-space ray of a candidate is recomputed when it is marched (a few
// dozen flops against a round trip through device memory), a candidate whose
// entry t is not below the best hit is never marched (the plain version
// marches it with t_max = -inf, where it retires at the slab test with 0
// steps and no hit), and a shadow trace writes 1 byte per ray instead of 49.
// Within a candidate the march stays as simple as before: one thread per
// ray with no shared memory, __ldg row loads, every lane retiring on its
// own.  Built with --fmad=false so that every operation rounds like the
// eager twin; sums run in the twin's order.

#include "scene.cuh"

namespace {

using namespace vrt;

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

__device__ __forceinline__ float eval_cubic(float t, float A, float B,
                                            float C, float D) {
  return ((A * t + B) * t + C) * t + D;
}

// What a march reports for one ray.
struct Hit {
  bool hit;
  float t;
  int kind;
  int cell[3];
  float t_in, t_out;
  float face[3];
  int steps;
};

// Where a kernel writes its rays' hits (the fields of MarchHit).
struct HitOut {
  uint8_t* hit;
  float* t;
  int32_t* kind;
  int32_t* cell;
  float* t_in;
  float* t_out;
  float* face;
  int32_t* steps;
};

__device__ __forceinline__ void store_hit(const HitOut& out, long long i,
                                          const Hit& h) {
  out.hit[i] = h.hit ? 1 : 0;
  out.t[i] = h.t;
  out.kind[i] = h.kind;
  out.t_in[i] = h.t_in;
  out.t_out[i] = h.t_out;
  out.steps[i] = h.steps;
  for (int k = 0; k < 3; ++k) {
    out.cell[3 * i + k] = h.cell[k];
    out.face[3 * i + k] = h.face[k];
  }
}

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

// The slab test of ray_aabb against the box [-ext, ext]^3: (intersects,
// t_enter, t_exit), with 1/d = -inf where d == 0.
__device__ __forceinline__ bool slab_test(const float o[3], const float d[3],
                                          float ext, float t_max,
                                          float* t_enter, float* t_exit) {
  float te = 0.0f, tx = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float inv = d[k] != 0.0f ? 1.0f / d[k] : -INFINITY;
    const float s_min = d[k] > 0.0f ? -ext : ext;
    const float s_max = d[k] > 0.0f ? ext : -ext;
    const float a = (s_min - o[k]) * inv;
    const float b = (s_max - o[k]) * inv;
    te = k == 0 ? a : nmax(te, a);
    tx = k == 0 ? b : nmin(tx, b);
  }
  *t_enter = te;
  *t_exit = tx;
  return (tx > te) && (tx >= 0.0f) && (te <= t_max);
}

// One ray (object-space o, d) through volume v of the stacked tables: what
// march_lanes_reference computes for one lane.
template <typename T, bool kCheb, bool kInterp, bool kDebug>
__device__ __forceinline__ void march_lane(const Tables& tb, int v,
                                           const float o[3],
                                           const float d[3], float t_max,
                                           Hit* out) {
  Lane L;
  for (int k = 0; k < 3; ++k) {
    L.o[k] = o[k];
    L.d[k] = d[k];
    L.inv[k] = L.d[k] != 0.0f ? 1.0f / L.d[k] : -INFINITY;
  }
  L.n = __ldg(tb.n + v);
  L.h = __ldg(tb.cell_size + v);
  L.ext = __ldg(tb.extends + v);
  const long long cc = tb.cc;
  const int ch = tb.ch;
  const long long vol_base = static_cast<long long>(v) * cc * cc * cc;
  const uint8_t* accel = tb.accel + vol_base;
  const T* corners = static_cast<const T*>(tb.corners) + vol_base * ch;
  const long long nn = cc + 1;
  const float* sdf = tb.sdf + static_cast<long long>(v) * nn * nn * nn;

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
    const T* row = corners + ((c[0] * cc + c[1]) * cc + c[2]) * ch;
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
  float t_enter, t_exit;
  const bool ok = slab_test(L.o, L.d, L.ext, t_max, &t_enter, &t_exit);
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

  out->hit = hit;
  out->t = t_best;
  out->kind = kind;
  out->t_in = t_in_best;
  out->t_out = t_out_best;
  out->steps = steps;
  for (int k = 0; k < 3; ++k) {
    out->cell[k] = cell_best[k];
    out->face[k] = face[k];
  }
}

struct LaneParams {
  const float* o;          // [L,3] object space
  const float* d;          // [L,3]
  const float* t_max;      // [L]
  const int32_t* vol_ids;  // [L]
  Tables tb;
  long long lanes;
  HitOut out;
};

template <typename T, bool kCheb, bool kInterp, bool kDebug>
__global__ void __launch_bounds__(256) march_kernel(const LaneParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.lanes) return;
  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = p.o[3 * i + k];
    d[k] = p.d[3 * i + k];
  }
  Hit h;
  march_lane<T, kCheb, kInterp, kDebug>(p.tb, p.vol_ids[i], o, d, p.t_max[i],
                                        &h);
  store_hit(p.out, i, h);
}

constexpr int kMaxInstances = 32;

struct SceneParams {
  const float* o_w;    // [R,3] world space
  const float* d_w;    // [R,3]
  const float* t_max;  // [R]
  Instances inst;
  Tables tb;
  long long rays;
  HitOut out;       // only out.hit is written with kAnyHit
  int32_t* winner;  // [R] winning instance, -1 for none
};

// march_scene_reference for one ray.  A candidate is live when its instance
// is active, its box is hit within t_max (ok) and its entry t lies below the
// best hit so far; its key is that entry t, or +inf when not ok.  An ok
// candidate's key is never +inf or NaN (t_exit > t_enter would fail), so
// "live" is "key < best_t", and as keys ascend and best_t only falls, the
// first dead candidate ends the loop.
template <typename T, bool kCheb, bool kInterp, bool kDebug, bool kAnyHit>
__global__ void __launch_bounds__(256) march_scene_kernel(
    const SceneParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.rays) return;
  float o_w[3], d_w[3], o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o_w[k] = p.o_w[3 * i + k];
    d_w[k] = p.d_w[3 * i + k];
  }
  const float t_max = p.t_max[i];

  // candidates in entry-t order: a stable insertion sort (an equal key stays
  // behind the lower instance index, as argsort(stable=True) leaves it)
  float key[kMaxInstances];
  uint8_t order[kMaxInstances];
  for (int a = 0; a < p.inst.count; ++a) {
    world_to_object(p.inst, a, o_w, d_w, o, d);
    const float ext = __ldg(p.tb.extends + __ldg(p.inst.volume + a));
    float t_enter, t_exit;
    const bool ok = slab_test(o, d, ext, t_max, &t_enter, &t_exit) &&
                    __ldg(p.inst.active + a) != 0;
    const float ka = ok ? t_enter : INFINITY;
    int j = a;
    for (; j > 0 && key[j - 1] > ka; --j) {
      key[j] = key[j - 1];
      order[j] = order[j - 1];
    }
    key[j] = ka;
    order[j] = static_cast<uint8_t>(a);
  }

  // the no-hit result, derived from the world origin as the reference
  // derives it
  const float zf = o_w[0] * 0.0f;
  Hit best;
  best.hit = false;
  best.t = zf + INFINITY;
  best.kind = 0;
  best.t_in = zf;
  best.t_out = zf;
  best.steps = 0;
  for (int k = 0; k < 3; ++k) {
    best.cell[k] = 0;
    best.face[k] = o_w[k] * 0.0f;
  }
  int winner = -1;
  float best_t = INFINITY;
  int steps = 0;
  for (int j = 0; j < p.inst.count && key[j] < best_t; ++j) {
    const int a = order[j];
    world_to_object(p.inst, a, o_w, d_w, o, d);
    Hit h;
    march_lane<T, kCheb, kInterp, kDebug>(p.tb, __ldg(p.inst.volume + a), o,
                                          d, nmin(t_max, best_t), &h);
    steps += h.steps;
    if (h.hit && h.t < best_t) {
      best = h;
      winner = a;
      best_t = h.t;
      // once a candidate wins, hit stays true whatever follows
      if (kAnyHit) break;
    }
  }
  if (kAnyHit) {
    p.out.hit[i] = best.hit ? 1 : 0;
    return;
  }
  best.steps = steps;
  store_hit(p.out, i, best);
  p.winner[i] = winner;
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + 255) / 256);
}

// Calls f.go<T, kCheb, kInterp, kDebug>() with the table type, the accel
// mode, the march mode and the overlay as compile-time flags.
template <typename T, bool kCheb, typename F>
void by_mode(const F& f, int interp, int debug) {
  if (interp) {
    if (debug) f.template go<T, kCheb, true, true>();
    else f.template go<T, kCheb, true, false>();
  } else {
    if (debug) f.template go<T, kCheb, false, true>();
    else f.template go<T, kCheb, false, false>();
  }
}

template <typename F>
void by_table(const F& f, int bf16, int chebyshev, int interp, int debug) {
  if (bf16) {
    if (chebyshev) by_mode<uint16_t, true>(f, interp, debug);
    else by_mode<uint16_t, false>(f, interp, debug);
  } else {
    if (chebyshev) by_mode<float, true>(f, interp, debug);
    else by_mode<float, false>(f, interp, debug);
  }
}

struct LaunchLanes {
  LaneParams p;
  cudaStream_t stream;
  template <typename T, bool kCheb, bool kInterp, bool kDebug>
  void go() const {
    march_kernel<T, kCheb, kInterp, kDebug>
        <<<grid_for(p.lanes), 256, 0, stream>>>(p);
  }
};

struct LaunchScene {
  SceneParams p;
  bool any_hit;  // never with the overlay: vrt_march_scene refuses it
  cudaStream_t stream;
  template <typename T, bool kCheb, bool kInterp, bool kDebug>
  void go() const {
    const unsigned grid = grid_for(p.rays);
    if (any_hit)
      march_scene_kernel<T, kCheb, kInterp, false, true>
          <<<grid, 256, 0, stream>>>(p);
    else
      march_scene_kernel<T, kCheb, kInterp, kDebug, false>
          <<<grid, 256, 0, stream>>>(p);
  }
};

}  // namespace

// One thread per object-space lane.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int vrt_march_lanes(
    const float* o, const float* d, const float* t_max,
    const int32_t* vol_ids, const int32_t* n, const float* cell_size,
    const float* extends, const uint8_t* accel, const void* corners,
    const float* sdf, int cc, int ch, int bf16, int chebyshev, int interp,
    int debug, long long lanes, uint8_t* hit, float* t, int32_t* kind,
    int32_t* cell, float* t_in, float* t_out, float* face, int32_t* steps,
    void* stream) {
  const LaneParams p{
      o, d, t_max, vol_ids,
      Tables{n, cell_size, extends, accel, corners, sdf, cc, ch}, lanes,
      HitOut{hit, t, kind, cell, t_in, t_out, face, steps}};
  by_table(LaunchLanes{p, static_cast<cudaStream_t>(stream)}, bf16, chebyshev,
           interp, debug);
  return static_cast<int>(cudaGetLastError());
}

// One thread per world ray over the scene's instances (at most 32).  With
// any_hit only ``hit`` is written (the other outputs may be null); the
// overlay has no any-hit variant.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a combination it does not take.
extern "C" int vrt_march_scene(
    const float* o_w, const float* d_w, const float* t_max,
    const int32_t* inst_volume, const float* inst_pos, const float* inst_rot,
    const float* inst_scale, const uint8_t* inst_active, int n_inst,
    const int32_t* n, const float* cell_size, const float* extends,
    const uint8_t* accel, const void* corners, const float* sdf, int cc,
    int ch, int bf16, int chebyshev, int interp, int debug, int any_hit,
    long long rays, uint8_t* hit, float* t, int32_t* kind, int32_t* cell,
    float* t_in, float* t_out, float* face, int32_t* steps, int32_t* winner,
    void* stream) {
  if (n_inst < 1 || n_inst > kMaxInstances || (any_hit && debug))
    return cudaErrorInvalidValue;
  const SceneParams p{
      o_w, d_w, t_max,
      Instances{inst_volume, inst_pos, inst_rot, inst_scale, inst_active,
                n_inst},
      Tables{n, cell_size, extends, accel, corners, sdf, cc, ch}, rays,
      HitOut{hit, t, kind, cell, t_in, t_out, face, steps}, winner};
  by_table(LaunchScene{p, any_hit != 0, static_cast<cudaStream_t>(stream)},
           bf16, chebyshev, interp, debug);
  return static_cast<int>(cudaGetLastError());
}
