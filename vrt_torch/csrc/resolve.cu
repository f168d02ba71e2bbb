// The fused resolve, forward and backward, for Hopper (sm_90a): one thread
// per ray turns a scene hit into (t, object-space normal, unlit), and one
// thread per ray pulls the cotangents of t and the normal back to the ray and
// to the corner table.
//
// ---- forward ----------------------------------------------------------------
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
//
// ---- backward ---------------------------------------------------------------
//
// It computes what renderer.resolve_scene_backward_reference computes (the
// closed form march/resolve.py::resolve_hits_backward, then the transpose of
// _world_to_object and a scatter-add): vrt gets the same gradient from XLA's
// transpose of resolve_hits and of its row gather (isosurface.py
// _take_rows_bwd).  Inputs: the rays, the hit's kind, t and cell, the
// cotangents g_t [R] and g_normal [R,3], the scene tables.  Outputs: g_o_w,
// g_d_w [R,3] and an f32 [V*C^3, ch] accumulator the caller zeroed.
//
// What bounds it: bytes.  A ray brings 8 B (kind, t), its two cotangents
// 16 B and takes 24 B away; a surface or solid-entry lane adds the ray and
// its instance (28 B), a surface lane its cell (12 B), seven rows read and up
// to 56 f32 atomics into rows its neighbours share.  At 1920x1080 that is
// about 100 MB plus the rows, 0.03 ms at 3.35 TB/s, beside the 19 to 67 MB
// accumulator that the caller zeroes.  The plain version over autograd
// instead keeps the [R,7,8] rows and some hundred [R]-shaped intermediates
// alive from the forward and differentiates them one eager kernel at a time.
//
// What the first design (resolve_bwd_kernel) does about it: a thread returns
// at once unless its kind carries a gradient (surface, solid entry); a
// surface lane re-reads its rows (cheaper than keeping 224 B a ray from the
// forward), folds each pair of neighbour rows into the three field values
// and nine derivatives it needs as they arrive, so no row stays in
// registers, and issues atomics only for non-zero cotangents.  The sums
// follow the closed form's order, not autograd's, and atomics add in an
// order that changes from run to run: the result agrees with the plain
// version to rounding, not bit for bit.
//
// What held it back, on the H100: the reductions.  A surface lane issues up
// to 56 scalar atomics (8 channels into each of 7 rows), and the lanes of a
// warp are neighbouring pixels that mostly hit the same cell, so they add
// into the same addresses at once and serialise in L2 (config6's primary
// rays: 97,675 surface lanes, ~5.5 M atomics, at 7% of the launch's bound).
// The bounce launches, with a few hundred hits, are set by their per-ray
// traffic: 2 M lanes storing 24 B each at a stride of 12 B.
//
// The redesign (resolve_bwd_merged_kernel, the default, below): resident
// blocks whose warps take rounds of 32 rays a grid apart, four at a time,
// the next four rounds' kinds loaded while they work; every lane of a warp
// stays to the merge point; the lanes whose hits name the same (volume,
// cell) are grouped with __match_any_sync and their row cotangents summed
// row by row by a shuffle tree into the group's lowest lane, which alone
// issues the reductions, two 16-byte red.global.add.v4.f32 a row into an
// accumulator of 16-byte rows (8 channels, or 12 for a 9-channel table: the
// caller gets the [rows, ch] view); a round without a surface or
// solid-entry lane writes its zero ray gradients in 16-byte stores; the
// others write theirs as 16-byte words through a per-warp stage in shared
// memory.  Each lane's own arithmetic is the first design's, so the ray
// gradients are bit-equal to it; only the table's sums change order.  On
// config6's primary rays the first design's ~5.4 M scalar atomics become at
// most ~0.28 M 16-byte reductions (counted on the host from the closed
// form's row cotangents and 32-ray warps); the hit path's 128 registers (capped: 2
// blocks an SM) leave 25% of the warp slots filled, which the resident
// blocks' prefetch of kinds works around on the miss rounds
// (vrt_torch.apps.probe_caps resolve_bwd times each choice).
//
// The instance variant (resolve_bwd_instances_kernel: the redesign's rounds
// with kInst, a scene's packed f32 or bf16 table) also pulls the cotangents
// back to the instance transforms, where a pose fit asks for them; vrt gets
// them from XLA's transpose of _world_to_object and of _per_ray_instance's
// gather.  A lane that carries a gradient forms its instance's (pos 3, rot
// 4, scale 3; scene.cuh object_bwd of its origin and its direction, the
// object-space cotangents the round already holds), whether or not its ray
// gradients are asked; the lanes of a warp on one instance sum them
// (__match_any_sync, a shuffle tree of 10 words) and the lowest adds them
// into the block's partial sums in shared memory (up to kMaxInstanceGrads
// instances), which the block adds into an f32 [I, 10] accumulator once at
// its end, one atomic a nonzero word.  It adds a carrying lane's transform
// (40 B, cached) and some 150 operations; the default instantiation is
// compiled as before.
//
// ---- a slab's planes, and the first design's slab table ---------------------
//
// One rank of a slab-sharded volume (vrt_torch.dist.brick) resolves against
// its own slab; vrt differentiates resolve_slab_hits (vrt/dist/brick.py) by
// XLA's transpose of its voxel fetch, no Pallas kernel.  The default reads
// the slab's voxel planes themselves (the kPlanes variants, SlabPlanes of
// scene.cuh: f32 [span, cc + 1, cc + 1], plane x holding global plane
// x0 + x): a row is the 8 voxels of its cell, each read on its own, a voxel
// outside the volume or the planes reading 0 as vrt's _slab_fetch reads it.
// The values are the table's wherever a cell lies inside the volume, so the
// forward equals the first design's bit for bit there.  The backward's
// merged kernel adds each merged row's 8 corner cotangents straight into an
// f32 gradient of the planes' shape (140 MB for one of four slabs of
// config5's 513^3 volume), a voxel outside the volume or the planes taking
// none, by scalar atomics (pairing the z-adjacent corners j and j + 4 into
// 8-byte red.global.add.v2.f32 where aligned measured slower; PERF.md keeps
// the times).  No table is packed, and no table gradient is written or
// carried back through a pack.
//
// The first design reads a slab-local f32 table of cx x-rows packed from
// the planes, row x holding cell x0 + x (x0 the slab's first plane); both
// backward designs take its rule as the kSlab template flag: the row of cell
// c is ((c[0] - x0) * cc + c[1]) * cc + c[2], and a cell outside the volume
// or the rows reads zeros and adds nothing (skipped, not clamped).  A
// scene's table (x0 0, cx cc) takes the variants without either flag, whose
// code is the one above.  The first design's accumulator has cx * cc * cc
// rows: 1.1 GB for one of config5's slabs, and the pack's backward carries
// it to the planes.

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
  // the corner table's x rows: row x holds cell x0 + x, for x in [0, cx)
  // (0 and cc for a scene's tables; a slab's own table otherwise)
  int x0, cx;
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

// The slab's planes of ResolveParams' or ResolveBwdParams' tables (kPlanes:
// corners points at the planes, cx is their span), n voxels a side.
template <typename P>
__device__ __forceinline__ SlabPlanes slab_planes(const P& p, int n) {
  return SlabPlanes{static_cast<const float*>(p.tb.corners),
                    static_cast<long long>(p.tb.cc) + 1, p.cx, p.x0, n};
}

// ---- the forward's redesign -------------------------------------------------
//
// What held the first design (resolve_kernel below) back on the H100
// (chip_smoke.py; ncu cannot run there): a lane without a hit loads its
// kind, and only then, as the kind decides, its face normal: two round
// trips to device memory where its bytes ask one, on nearly every lane of
// the flagship's bounce levels (0.032 ms a launch against about 0.020 ms
// of bytes); a surface lane loads its ray, instance and cell after its
// kind.
//
// The redesign (resolve_lean_kernel, the default): one thread a ray over
// the whole grid, as the first design; every lane loads its kind, t and
// face normal at once (the face normal whatever the kind), a surface or
// solid-entry lane its ray, instance and cell at once after them, so a
// lane without a hit waits one round trip and a surface lane two before
// its transform and rows; the registers capped at 48 (5 blocks of 256 an
// SM, 62% of the warp slots; uncapped the redesign takes 80-120 and fills
// 25-38%).  Measured on the card and dropped, each slower than the first
// design on the flagship frame: resident blocks striding over the rays
// (with the instance and volume tables staged in shared memory, a warp's
// kinds, t and face normals fetched rounds ahead by cp.async, and its
// [32,3] spans moved as 16-byte words through shared memory), the tables
// staged in shared memory alone, the spans alone, and a surface lane's six
// neighbour rows, or an axis' two, loaded before the trilinears that read
// them (more registers at every cap).  Both designs run one lane's
// arithmetic (resolve_lane) and differ in their loads and register cap
// only, so every output of the redesign is bit-equal to the first design's
// (and so to the plain version).  The block and the register cap are the
// probe's (vrt_torch.apps.probe_caps resolve_fwd).

constexpr int kResolveThreads = 256;
// blocks an SM must hold at once, a register cap (1: none)
constexpr int kResolveMinBlocks = 5;

// One lane of either design: t and the normal of a ray of kind ``kind``
// from the inputs the lane read (o_w, d_w and the instance ``a`` on
// surface and solid-entry lanes, cell on surface lanes, face elsewhere but
// on debug lanes).
template <typename E, bool kV16, bool kPlanes>
__device__ __forceinline__ void resolve_lane(
    const ResolveParams& p, int kind, float t0, int a, const float o_w[3],
    const float d_w[3], const int cell[3], const float face[3], float& t,
    float normal[3]) {
  t = t0;
  if (kind == kKindSurface || kind == kKindSolidEntry) {
    float o[3], d[3];
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
      for (int k = 0; k < 3; ++k) normal[k] = face[k];
      return;
    }
    const int n = __ldg(p.tb.n + v);
    const float h = __ldg(p.tb.cell_size + v);
    const long long cc = p.tb.cc;
    const E* table = static_cast<const E*>(p.tb.corners) +
                     static_cast<long long>(v) * cc * cc * cc * p.tb.ch;
    t = isfinite(t0) ? t0 : 0.0f;
    float q[3];
    for (int k = 0; k < 3; ++k) {
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
        float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (kPlanes) {
          slab_planes(p, n).corners(c, v8);
        } else {
          const int lx = c[0] - p.x0;
          const bool valid = c[0] >= 0 && c[1] >= 0 && c[2] >= 0 &&
                             c[0] + 1 < n && c[1] + 1 < n && c[2] + 1 < n &&
                             lx >= 0 && lx < p.cx;
          if (valid)
            load_row<E, kV16>(
                table + ((lx * cc + c[1]) * cc + c[2]) * p.tb.ch, v8);
        }
        f[s] = trilinear(v8, q);
      }
      g[k] = f[0] - f[1];
    }
    const float n2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2];
    const bool good = n2 > 0.0f && isfinite(n2);
    const float norm = sqrtf(good ? n2 : 1.0f);
    for (int k = 0; k < 3; ++k) normal[k] = good ? g[k] / norm : 0.0f;
  } else if (kind == kKindDebug) {
    normal[0] = 1.0f;
    normal[1] = 0.0f;
    normal[2] = 0.0f;
  } else {
    for (int k = 0; k < 3; ++k) normal[k] = face[k];
  }
}

// The first design: one thread a ray; a lane loads its kind and t, then
// what its kind reads.
template <typename E, bool kV16, bool kPlanes = false>
__global__ void __launch_bounds__(256) resolve_kernel(const ResolveParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.rays) return;
  const int kind = p.kind[i];
  const float t0 = p.t[i];
  float o_w[3] = {0.0f, 0.0f, 0.0f}, d_w[3] = {0.0f, 0.0f, 0.0f};
  float face[3] = {0.0f, 0.0f, 0.0f};
  int cell[3] = {0, 0, 0};
  int a = 0;
  if (kind == kKindSurface || kind == kKindSolidEntry) {
    for (int k = 0; k < 3; ++k) {
      o_w[k] = p.o_w[3 * i + k];
      d_w[k] = p.d_w[3 * i + k];
    }
    a = max(p.winner[i], 0);
  }
  if (kind == kKindSurface) {
    for (int k = 0; k < 3; ++k) cell[k] = p.cell[3 * i + k];
  } else if (kind != kKindDebug) {
    for (int k = 0; k < 3; ++k) face[k] = p.face[3 * i + k];
  }
  float t, normal[3];
  resolve_lane<E, kV16, kPlanes>(p, kind, t0, a, o_w, d_w, cell, face, t,
                                 normal);
  p.t_out[i] = t;
  p.unlit[i] = (kind == kKindExhausted || kind == kKindDebug) ? 1 : 0;
  for (int k = 0; k < 3; ++k) p.normal[3 * i + k] = normal[k];
}

template <typename E, bool kV16, bool kPlanes>
__global__ void __launch_bounds__(kResolveThreads, kResolveMinBlocks)
    resolve_lean_kernel(const ResolveParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kResolveThreads +
                      threadIdx.x;
  if (i >= p.rays) return;
  // what a lane without a hit reads, in one round trip
  const int kind = p.kind[i];
  const float t0 = p.t[i];
  float face[3];
  for (int k = 0; k < 3; ++k) face[k] = p.face[3 * i + k];
  // what a surface or solid-entry lane reads besides, in one more
  const bool carries = kind == kKindSurface || kind == kKindSolidEntry;
  float o_w[3] = {0.0f, 0.0f, 0.0f}, d_w[3] = {0.0f, 0.0f, 0.0f};
  int cell[3] = {0, 0, 0};
  int a = 0;
  if (carries) {
    a = max(p.winner[i], 0);
    for (int k = 0; k < 3; ++k) {
      o_w[k] = p.o_w[3 * i + k];
      d_w[k] = p.d_w[3 * i + k];
      cell[k] = p.cell[3 * i + k];
    }
  }
  float t, normal[3];
  resolve_lane<E, kV16, kPlanes>(p, kind, t0, a, o_w, d_w, cell, face, t,
                                 normal);
  p.t_out[i] = t;
  p.unlit[i] = (kind == kKindExhausted || kind == kKindDebug) ? 1 : 0;
  for (int k = 0; k < 3; ++k) p.normal[3 * i + k] = normal[k];
}

struct ResolveBwdParams {
  const float* o_w;        // [R,3]
  const float* d_w;        // [R,3]
  const int32_t* winner;   // [R] instance, -1 for none
  const int32_t* kind;     // [R]
  const float* t;          // [R]
  const int32_t* cell;     // [R,3]
  const float* g_t;        // [R] cotangent of t
  const float* g_normal;   // [R,3] cotangent of the normal
  Instances inst;
  Tables tb;
  long long rays;
  float* g_o_w;            // [R,3] or null
  float* g_d_w;            // [R,3] or null
  float* acc;              // [V*C^3, ch] f32, zeroed by the caller, or null
  // the table's x rows, as ResolveParams' (read with kSlab only)
  int x0, cx;
};

// The trilinear weights at q and their derivatives, per axis k and corner
// bit b: a = (1 - b) - q_k, m = |a|, s = d|a|/dq_k = -(a >= 0 ? 1 : -1):
// vrt's derivative of |a| (jnp.abs'), 1 at 0 and at -0, where torch's abs
// takes 0 (march/resolve.py's closed forms and core/kinks.py's abs_ agree).
struct Weights {
  float m[3][2];
  float s[3][2];
  __device__ __forceinline__ explicit Weights(const float q[3]) {
    #pragma unroll
    for (int k = 0; k < 3; ++k)
      for (int b = 0; b < 2; ++b) {
        const float a = (b ? 0.0f : 1.0f) - q[k];
        m[k][b] = fabsf(a);
        s[k][b] = a >= 0.0f ? -1.0f : 1.0f;
      }
  }
  // corner i's weight (w0 * w1) * w2
  __device__ __forceinline__ float w(int i) const {
    return (m[0][i & 1] * m[1][(i >> 1) & 1]) * m[2][(i >> 2) & 1];
  }
  // its derivative in q_k
  __device__ __forceinline__ float dw(int i, int k) const {
    const int b0 = i & 1, b1 = (i >> 1) & 1, b2 = (i >> 2) & 1;
    if (k == 0) return s[0][b0] * (m[1][b1] * m[2][b2]);
    if (k == 1) return s[1][b1] * (m[0][b0] * m[2][b2]);
    return s[2][b2] * (m[0][b0] * m[1][b1]);
  }
  // sum8 of w * v, and of dw/dq_k * v
  __device__ __forceinline__ float field(const float v[8]) const {
    float term[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) term[i] = w(i) * v[i];
    return sum8(term);
  }
  __device__ __forceinline__ float field_dq(const float v[8], int k) const {
    float term[8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) term[i] = dw(i, k) * v[i];
    return sum8(term);
  }
};

__device__ __forceinline__ bool cell_valid(const int c[3], int n) {
  return c[0] >= 0 && c[1] >= 0 && c[2] >= 0 && c[0] + 1 < n &&
         c[1] + 1 < n && c[2] + 1 < n;
}

// Whether cell c has a row in its volume's table: in range, and with kSlab
// inside the table's x rows [x0, x0 + cx) too.  Without kSlab these helpers
// fold to the expressions of the scene's variants before the slab's.
template <bool kSlab>
__device__ __forceinline__ bool row_valid(const ResolveBwdParams& p,
                                          const int c[3], int n) {
  if (kSlab) {
    const int lx = c[0] - p.x0;
    return cell_valid(c, n) && lx >= 0 && lx < p.cx;
  }
  return cell_valid(c, n);
}

// The row of cell c in its volume's table (meaningful where row_valid).
template <bool kSlab>
__device__ __forceinline__ long long row_index(const ResolveBwdParams& p,
                                               const int c[3], long long cc) {
  return ((kSlab ? c[0] - p.x0 : c[0]) * cc + c[1]) * cc + c[2];
}

// The first row of volume v: v * cc^3 for a scene's tables, v * cx * cc^2
// for a slab's.
template <bool kSlab>
__device__ __forceinline__ long long volume_base(const ResolveBwdParams& p,
                                                 int v, long long cc) {
  return kSlab ? static_cast<long long>(v) * p.cx * cc * cc
               : static_cast<long long>(v) * cc * cc * cc;
}

// acc[row, i] += g * w_i for the 8 corner channels; zeros are skipped
// (x + 0 == x), which drops the lanes whose pixels the loss does not see.
__device__ __forceinline__ void add_row(float* row, const Weights& wt,
                                        float g) {
  if (g == 0.0f) return;
  #pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = g * wt.w(i);
    if (v != 0.0f) atomicAdd(row + i, v);
  }
}

template <typename E, bool kV16, bool kSlab>
__global__ void __launch_bounds__(256) resolve_bwd_kernel(
    const ResolveBwdParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.rays) return;
  const int kind = p.kind[i];
  float g_o[3] = {0.0f, 0.0f, 0.0f};
  float g_d[3] = {0.0f, 0.0f, 0.0f};
  const bool rays_grad = p.g_o_w != nullptr;
  if (kind != kKindSurface && kind != kKindSolidEntry) {
    // exhausted, debug, cube and miss lanes carry no gradient
    if (rays_grad)
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        p.g_o_w[3 * i + k] = 0.0f;
        p.g_d_w[3 * i + k] = 0.0f;
      }
    return;
  }

  float o_w[3], d_w[3], o[3], d[3];
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_w[k] = p.o_w[3 * i + k];
    d_w[k] = p.d_w[3 * i + k];
  }
  const int a = max(p.winner[i], 0);
  world_to_object(p.inst, a, o_w, d_w, o, d);
  const int v = __ldg(p.inst.volume + a);
  const float ext = __ldg(p.tb.extends + v);
  const float g_t = p.g_t[i];

  if (kind == kKindSolidEntry) {
    // resolve.py _slab_enter: the axes that attain the maximum share g_t
    // evenly; only finite axes pass it on
    float tk[3], inv[3];
    float te = 0.0f;
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool finite = d[k] != 0.0f;
      const float s_min = d[k] > 0.0f ? -ext : ext;
      inv[k] = finite ? 1.0f / d[k] : 0.0f;
      tk[k] = finite ? (s_min - o[k]) * inv[k] : -INFINITY;
      te = k == 0 ? tk[k] : nmax(te, tk[k]);
    }
    int ties = 0;
    #pragma unroll
    for (int k = 0; k < 3; ++k) ties += tk[k] == te ? 1 : 0;
    const float share = g_t / static_cast<float>(max(ties, 1));
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool takes = tk[k] == te && d[k] != 0.0f;
      g_o[k] = takes ? -share * inv[k] : 0.0f;
      g_d[k] = takes ? g_o[k] * tk[k] : 0.0f;
    }
  } else {
    const int n = __ldg(p.tb.n + v);
    const float h = __ldg(p.tb.cell_size + v);
    const long long cc = p.tb.cc;
    const int ch = p.tb.ch;
    const long long vol_rows = volume_base<kSlab>(p, v, cc);
    const E* table = static_cast<const E*>(p.tb.corners) + vol_rows * ch;
    float* acc = p.acc == nullptr ? nullptr : p.acc + vol_rows * ch;
    const float t0r = p.t[i];
    const float t0 = isfinite(t0r) ? t0r : 0.0f;
    int cell[3];
    float q[3], dh[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      cell[k] = p.cell[3 * i + k];
      const float base = static_cast<float>(cell[k]) * h - ext;
      q[k] = ((o[k] + d[k] * t0) - base) / h;
      dh[k] = d[k] / h;
    }
    const Weights wt(q);

    // central differences: each pair of neighbour rows folds into the
    // field value g[k] and its derivatives dg[k][m] in q_m as it arrives
    float g[3], dg[3][3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      float diff[8];
      #pragma unroll
      for (int s = 0; s < 2; ++s) {
        int c[3] = {cell[0], cell[1], cell[2]};
        c[k] += s == 0 ? 1 : -1;
        float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row_valid<kSlab>(p, c, n))
          load_row<E, kV16>(table + row_index<kSlab>(p, c, cc) * ch, v8);
        #pragma unroll
        for (int j = 0; j < 8; ++j)
          diff[j] = s == 0 ? v8[j] : diff[j] - v8[j];
      }
      g[k] = wt.field(diff);
      #pragma unroll
      for (int m = 0; m < 3; ++m) dg[k][m] = wt.field_dq(diff, m);
    }

    // the unit normal's backward
    const float n2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2];
    const bool good = n2 > 0.0f && isfinite(n2);
    const float n2s = good ? n2 : 1.0f;
    const float norm = sqrtf(n2s);
    float gn[3], g_g[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) gn[k] = p.g_normal[3 * i + k];
    const float dot = (gn[0] * g[0] + gn[1] * g[1]) + gn[2] * g[2];
    #pragma unroll
    for (int k = 0; k < 3; ++k)
      g_g[k] = good ? gn[k] / norm - dot * g[k] / (norm * n2s) : 0.0f;

    // into the hit point, then into t_surface
    float g_p[3];
    #pragma unroll
    for (int m = 0; m < 3; ++m)
      g_p[m] = (g_g[0] * dg[0][m] + g_g[1] * dg[1][m]) + g_g[2] * dg[2][m];
    const float g_ts =
        g_t + ((g_p[0] * dh[0] + g_p[1] * dh[1]) + g_p[2] * dh[2]);

    // the IFT term: F'(t0) in _trilinear_rows_dt's order, so that ``safe``
    // decides as the plain version does
    float vc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const bool center = row_valid<kSlab>(p, cell, n);
    const long long center_row = row_index<kSlab>(p, cell, cc);
    if (center) load_row<E, kV16>(table + center_row * ch, vc);
    float term[8];
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b[3] = {j & 1, (j >> 1) & 1, (j >> 2) & 1};
      float w[3], dwq[3];
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[k] = wt.m[k][b[k]];
        dwq[k] = wt.s[k][b[k]] * dh[k];
      }
      term[j] = ((dwq[0] * w[1] + w[0] * dwq[1]) * w[2] +
                 (w[0] * w[1]) * dwq[2]) * vc[j];
    }
    const float fp = sum8(term);
    const bool safe = isfinite(fp) && fabsf(fp) > 1e-12f;
    const float g_f0 = safe ? -g_ts / fp : 0.0f;
    #pragma unroll
    for (int m = 0; m < 3; ++m) {
      g_p[m] = g_p[m] + g_f0 * wt.field_dq(vc, m);
      g_o[m] = g_p[m] / h;
      g_d[m] = g_o[m] * t0;
    }

    // the rows: g_f0 * w into the hit cell's, +-g_g[k] * w into the
    // neighbours'; an out-of-range row gets none
    if (acc != nullptr) {
      if (center) add_row(acc + center_row * ch, wt, g_f0);
      #pragma unroll
      for (int k = 0; k < 3; ++k)
        for (int s = 0; s < 2; ++s) {
          int c[3] = {cell[0], cell[1], cell[2]};
          c[k] += s == 0 ? 1 : -1;
          if (row_valid<kSlab>(p, c, n))
            add_row(acc + row_index<kSlab>(p, c, cc) * ch, wt,
                    s == 0 ? g_g[k] : -g_g[k]);
        }
    }
  }

  if (rays_grad) {
    // the transpose of world_to_object: rotate by rot, divide by scale
    float qv[3], go[3], gd[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) qv[k] = __ldg(p.inst.rot + 4 * a + k);
    const float qw = __ldg(p.inst.rot + 4 * a + 3);
    rotate(qv, qw, g_o, go);
    rotate(qv, qw, g_d, gd);
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = __ldg(p.inst.scale + 3 * a + k);
      p.g_o_w[3 * i + k] = go[k] / s;
      p.g_d_w[3 * i + k] = gd[k] / s;
    }
  }
}

// ---- the backward's redesign ------------------------------------------------

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kBwdThreads = 256;
// Switches of the redesign, rewritten by vrt_torch.apps.probe_caps to time
// what each part buys: merge a warp's row cotangents before the reductions;
// 16-byte vector reductions (false: one scalar atomic a channel).  Its
// sizes: the rounds of 32 rays a warp takes at a time, whose kinds it loads
// at once (a launch on bounce rays is mostly warps without a hit, which only
// read their kinds and write zeros: more loads in flight a warp); blocks an
// SM must hold at once, a register cap (1: none; the probe varies it).
constexpr bool kMergeRows = true;
constexpr bool kVecReduce = true;
constexpr int kBwdRounds = 4;
constexpr int kBwdMinBlocks = 2;

__device__ __forceinline__ void red_add_v4(float* dst, const float v[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(dst), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// acc_row[0..7] += v; a zero is skipped (x + 0 == x), a vector of four
// zeros too.  acc_row is 16-byte aligned.
__device__ __forceinline__ void add_row8(float* acc_row, const float v[8]) {
  #pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* u = v + 4 * q;
    if (kVecReduce) {
      if (u[0] != 0.0f || u[1] != 0.0f || u[2] != 0.0f || u[3] != 0.0f)
        red_add_v4(acc_row + 4 * q, u);
    } else {
      #pragma unroll
      for (int c = 0; c < 4; ++c)
        if (u[c] != 0.0f) atomicAdd(acc_row + 4 * q + c, u[c]);
    }
  }
}

// The planes' gradient at the 8 corners of cell c += v: a zero is skipped, a
// voxel outside the volume or the planes takes none.  Corners j and j + 4
// (z and z + 1) share one index computation.
__device__ __forceinline__ void add_planes(float* g, const SlabPlanes& sp,
                                           const int c[3], const float v[8]) {
  #pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (v[j] == 0.0f && v[j + 4] == 0.0f) continue;
    const int x = c[0] + (j & 1), y = c[1] + ((j >> 1) & 1), z = c[2];
    const bool lo = sp.valid(x, y, z), hi = sp.valid(x, y, z + 1);
    const long long i = sp.index(x, y, z);
    if (lo && v[j] != 0.0f) atomicAdd(g + i, v[j]);
    if (hi && v[j + 4] != 0.0f) atomicAdd(g + i + 1, v[j + 4]);
  }
}

// Sums v over each group of lanes that ``peers`` (this lane's
// __match_any_sync mask) names, by a segmented tree reduction (log2 of the
// largest group's size rounds of N shuffles), into the group's lowest lane,
// which is returned; every lane of the warp calls it.  Lanes whose groups
// are all single skip the rounds.
template <int N>
__device__ __forceinline__ int merge_peers(unsigned peers, float (&v)[N],
                                           int lane) {
  unsigned above = peers & (0xfffffffeu << lane);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(kFullWarp, above != 0u)) {
    const int next = __ffs(above);              // 1 + the next peer's lane
    #pragma unroll
    for (int e = 0; e < N; ++e) {
      const float o = __shfl_sync(kFullWarp, v[e], next > 0 ? next - 1 : lane);
      if (next > 0) v[e] += o;
    }
    // a peer at an odd rank has handed its sum down: drop it
    above &= ~__ballot_sync(kFullWarp, rank & 1u);
    rank >>= 1;
  }
  return __ffs(peers) - 1;
}

// g * w_c for the 8 corner channels, 0 where g is 0 (the first design skips
// such a row whatever its weights).
__device__ __forceinline__ void row_values(float g, const float w[8],
                                           float v[8]) {
  #pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = g == 0.0f ? 0.0f : g * w[c];
}

// One round of a warp: the 32 rays from w0, this lane's of kind ``kind``.
// Every lane of the warp calls it and none leaves before the merge.  With
// kPlanes (a slab's planes; kSlab's rows are not used) rows[0] is the hit
// cell's key on a surface lane, and the group's lowest lane adds the seven
// merged rows into the planes' gradient by voxel.  With kInst (the instance
// variant) a lane that carries a gradient also forms its instance
// transform's cotangents (object_bwd of its ray's origin and direction);
// the lanes of one instance sum them, and the lowest adds the sums into the
// block's partial sums sh_inst (kInstanceWords an instance).
template <typename E, bool kV16, bool kSlab, bool kPlanes,
          bool kInst = false>
__device__ __forceinline__ void backward_round(const ResolveBwdParams& p,
                                               int acc_w, long long w0,
                                               int lane, int kind,
                                               float* stage,
                                               float* sh_inst = nullptr) {
  const long long i = w0 + lane;
  const bool in = i < p.rays;
  const bool full = w0 + 32 <= p.rays;
  const bool carries = kind == kKindSurface || kind == kKindSolidEntry;
  const bool rays_grad = p.g_o_w != nullptr;
  if (__ballot_sync(kFullWarp, carries) == 0u) {
    // exhausted, debug, cube and miss lanes carry no gradient
    if (rays_grad) {
      if (full) {
        // [32,3] floats are 24 float4s
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (lane < 24) {
          reinterpret_cast<float4*>(p.g_o_w + 3 * w0)[lane] = z;
          reinterpret_cast<float4*>(p.g_d_w + 3 * w0)[lane] = z;
        }
      } else if (in) {
        #pragma unroll
        for (int k = 0; k < 3; ++k) {
          p.g_o_w[3 * i + k] = 0.0f;
          p.g_d_w[3 * i + k] = 0.0f;
        }
      }
    }
    return;
  }

  float g_o[3] = {0.0f, 0.0f, 0.0f};
  float g_d[3] = {0.0f, 0.0f, 0.0f};
  // the rows: the hit cell's (r = 0) and its neighbours' (r = 1 + 2k + s),
  // each its index among the accumulator's rows or -1 (out of range, or not
  // a surface lane), its cotangent g and the 8 trilinear weights
  long long rows[7];
  float coef[7], w8[8];
  #pragma unroll
  for (int r = 0; r < 7; ++r) {
    rows[r] = -1;
    coef[r] = 0.0f;
  }
  #pragma unroll
  for (int c = 0; c < 8; ++c) w8[c] = 0.0f;
  int a = 0;
  int hit_cell[3] = {0, 0, 0};
  int vol_n = 0;
  if (carries) {
    float o_w[3], d_w[3], o[3], d[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      o_w[k] = p.o_w[3 * i + k];
      d_w[k] = p.d_w[3 * i + k];
    }
    a = max(p.winner[i], 0);
    world_to_object(p.inst, a, o_w, d_w, o, d);
    const int v = __ldg(p.inst.volume + a);
    const float ext = __ldg(p.tb.extends + v);
    const float g_t = p.g_t[i];

    if (kind == kKindSolidEntry) {
      // resolve.py _slab_enter: the axes that attain the maximum share g_t
      // evenly; only finite axes pass it on
      float tk[3], inv[3];
      float te = 0.0f;
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        const bool finite = d[k] != 0.0f;
        const float s_min = d[k] > 0.0f ? -ext : ext;
        inv[k] = finite ? 1.0f / d[k] : 0.0f;
        tk[k] = finite ? (s_min - o[k]) * inv[k] : -INFINITY;
        te = k == 0 ? tk[k] : nmax(te, tk[k]);
      }
      int ties = 0;
      #pragma unroll
      for (int k = 0; k < 3; ++k) ties += tk[k] == te ? 1 : 0;
      const float share = g_t / static_cast<float>(max(ties, 1));
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        const bool takes = tk[k] == te && d[k] != 0.0f;
        g_o[k] = takes ? -share * inv[k] : 0.0f;
        g_d[k] = takes ? g_o[k] * tk[k] : 0.0f;
      }
    } else {
      const int n = __ldg(p.tb.n + v);
      const float h = __ldg(p.tb.cell_size + v);
      const long long cc = p.tb.cc;
      const int ch = p.tb.ch;
      const long long vol_rows = volume_base<kSlab>(p, v, cc);
      const E* table = static_cast<const E*>(p.tb.corners) + vol_rows * ch;
      const float t0r = p.t[i];
      const float t0 = isfinite(t0r) ? t0r : 0.0f;
      int cell[3];
      float q[3], dh[3];
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        cell[k] = p.cell[3 * i + k];
        hit_cell[k] = cell[k];
        const float base = static_cast<float>(cell[k]) * h - ext;
        q[k] = ((o[k] + d[k] * t0) - base) / h;
        dh[k] = d[k] / h;
      }
      vol_n = n;
      const Weights wt(q);

      // central differences: each pair of neighbour rows folds into the
      // field value g[k] and its derivatives dg[k][m] in q_m as it arrives
      float g[3], dg[3][3];
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        float diff[8];
        #pragma unroll
        for (int s = 0; s < 2; ++s) {
          int c[3] = {cell[0], cell[1], cell[2]};
          c[k] += s == 0 ? 1 : -1;
          float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          const long long row = row_index<kSlab>(p, c, cc);
          if (kPlanes) {
            slab_planes(p, n).corners(c, v8);
          } else if (row_valid<kSlab>(p, c, n)) {
            load_row<E, kV16>(table + row * ch, v8);
            rows[1 + 2 * k + s] = vol_rows + row;
          }
          #pragma unroll
          for (int j = 0; j < 8; ++j)
            diff[j] = s == 0 ? v8[j] : diff[j] - v8[j];
        }
        g[k] = wt.field(diff);
        #pragma unroll
        for (int m = 0; m < 3; ++m) dg[k][m] = wt.field_dq(diff, m);
      }

      // the unit normal's backward
      const float n2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2];
      const bool good = n2 > 0.0f && isfinite(n2);
      const float n2s = good ? n2 : 1.0f;
      const float norm = sqrtf(n2s);
      float gn[3], g_g[3];
      #pragma unroll
      for (int k = 0; k < 3; ++k) gn[k] = p.g_normal[3 * i + k];
      const float dot = (gn[0] * g[0] + gn[1] * g[1]) + gn[2] * g[2];
      #pragma unroll
      for (int k = 0; k < 3; ++k)
        g_g[k] = good ? gn[k] / norm - dot * g[k] / (norm * n2s) : 0.0f;

      // into the hit point, then into t_surface
      float g_p[3];
      #pragma unroll
      for (int m = 0; m < 3; ++m)
        g_p[m] = (g_g[0] * dg[0][m] + g_g[1] * dg[1][m]) + g_g[2] * dg[2][m];
      const float g_ts =
          g_t + ((g_p[0] * dh[0] + g_p[1] * dh[1]) + g_p[2] * dh[2]);

      // the IFT term: F'(t0) in _trilinear_rows_dt's order, so that
      // ``safe`` decides as the plain version does
      float vc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const long long center_row = row_index<kSlab>(p, cell, cc);
      if (kPlanes) {
        slab_planes(p, n).corners(cell, vc);
        // the hit cell's key (cells in [-1, n] a side map one to one)
        rows[0] = ((static_cast<long long>(cell[0]) + 1) * (n + 2) +
                   (cell[1] + 1)) * (n + 2) + (cell[2] + 1);
      } else if (row_valid<kSlab>(p, cell, n)) {
        load_row<E, kV16>(table + center_row * ch, vc);
        rows[0] = vol_rows + center_row;
      }
      float term[8];
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b[3] = {j & 1, (j >> 1) & 1, (j >> 2) & 1};
        float w[3], dwq[3];
        #pragma unroll
        for (int k = 0; k < 3; ++k) {
          w[k] = wt.m[k][b[k]];
          dwq[k] = wt.s[k][b[k]] * dh[k];
        }
        term[j] = ((dwq[0] * w[1] + w[0] * dwq[1]) * w[2] +
                   (w[0] * w[1]) * dwq[2]) * vc[j];
      }
      const float fp = sum8(term);
      const bool safe = isfinite(fp) && fabsf(fp) > 1e-12f;
      const float g_f0 = safe ? -g_ts / fp : 0.0f;
      #pragma unroll
      for (int m = 0; m < 3; ++m) {
        g_p[m] = g_p[m] + g_f0 * wt.field_dq(vc, m);
        g_o[m] = g_p[m] / h;
        g_d[m] = g_o[m] * t0;
      }

      // g_f0 * w into the hit cell's row, +-g_g[k] * w into the neighbours'
      coef[0] = g_f0;
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        coef[1 + 2 * k] = g_g[k];
        coef[2 + 2 * k] = -g_g[k];
      }
      #pragma unroll
      for (int c = 0; c < 8; ++c) w8[c] = wt.w(c);
    }
  }

  if (p.acc != nullptr) {
    // every lane of the warp takes part; a lane without rows merges alone
    // (a key no other lane holds) and adds nothing.  Lanes of one (volume,
    // cell) share all seven rows and which of them are in range; a lane
    // whose hit cell is out of range merges alone.  The rows merge one
    // after another, so that 8 sums are in flight, not 56.
    float* acc = p.acc;
    unsigned peers = 1u << lane;
    if (kMergeRows)
      peers = __match_any_sync(kFullWarp,
                               rows[0] >= 0 ? rows[0] : -1 - lane);
    #pragma unroll
    for (int r = 0; r < 7; ++r) {
      float v[8];
      row_values(coef[r], w8, v);
      const bool leads = kMergeRows ? merge_peers(peers, v, lane) == lane
                                    : true;
      if (kPlanes) {
        if (leads && rows[0] >= 0) {
          // row r is the hit cell (r = 0) or its neighbour 1 + 2k + s
          int c[3] = {hit_cell[0], hit_cell[1], hit_cell[2]};
          if (r > 0) c[(r - 1) >> 1] += ((r - 1) & 1) ? -1 : 1;
          add_planes(acc, slab_planes(p, vol_n), c, v);
        }
      } else if (leads && rows[r] >= 0) {
        add_row8(acc + rows[r] * acc_w, v);
      }
    }
  }

  if (kInst) {
    // the transform's cotangents from the object-space ray's, after the
    // rows' merge, the ray and the transform read again (cached), so that
    // none of it is held through the merge
    float gi[kInstanceWords];
    #pragma unroll
    for (int e = 0; e < kInstanceWords; ++e) gi[e] = 0.0f;
    if (carries) {
      float o_w[3], d_w[3], pos[3], rot[4], scale[3];
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        o_w[k] = p.o_w[3 * i + k];
        d_w[k] = p.d_w[3 * i + k];
        pos[k] = __ldg(p.inst.pos + 3 * a + k);
        scale[k] = __ldg(p.inst.scale + 3 * a + k);
      }
      #pragma unroll
      for (int k = 0; k < 4; ++k) rot[k] = __ldg(p.inst.rot + 4 * a + k);
      object_bwd<true>(pos, rot, scale, o_w, g_o, gi);
      object_bwd<false>(pos, rot, scale, d_w, g_d, gi);
    }
    // the lanes of one instance summed, the lowest adding the sums into the
    // block's; a lane without a gradient merges alone and adds nothing
    const unsigned peers = __match_any_sync(kFullWarp, carries ? a : -1 - lane);
    if (merge_peers(peers, gi, lane) == lane && carries)
      #pragma unroll
      for (int e = 0; e < kInstanceWords; ++e)
        if (gi[e] != 0.0f) atomicAdd(sh_inst + a * kInstanceWords + e, gi[e]);
  }

  if (rays_grad) {
    // the transpose of world_to_object: rotate by rot, divide by scale;
    // exact zeros on the lanes without a gradient, as the first design
    float go_w[3] = {0.0f, 0.0f, 0.0f}, gd_w[3] = {0.0f, 0.0f, 0.0f};
    if (carries) {
      float qv[3], go[3], gd[3];
      #pragma unroll
      for (int k = 0; k < 3; ++k) qv[k] = __ldg(p.inst.rot + 4 * a + k);
      const float qw = __ldg(p.inst.rot + 4 * a + 3);
      rotate(qv, qw, g_o, go);
      rotate(qv, qw, g_d, gd);
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float s = __ldg(p.inst.scale + 3 * a + k);
        go_w[k] = go[k] / s;
        gd_w[k] = gd[k] / s;
      }
    }
    if (full) {
      // the warp's [32,3] spans through its stage, as 24 float4s each
      float* so = stage;
      float* sd = stage + 96;
      __syncwarp();                          // the last round's reads
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        so[3 * lane + k] = go_w[k];
        sd[3 * lane + k] = gd_w[k];
      }
      __syncwarp();
      if (lane < 24) {
        reinterpret_cast<float4*>(p.g_o_w + 3 * w0)[lane] =
            reinterpret_cast<const float4*>(so)[lane];
        reinterpret_cast<float4*>(p.g_d_w + 3 * w0)[lane] =
            reinterpret_cast<const float4*>(sd)[lane];
      }
    } else if (in) {
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        p.g_o_w[3 * i + k] = go_w[k];
        p.g_d_w[3 * i + k] = gd_w[k];
      }
    }
  }
}

// Resident blocks: warp w takes the rounds of 32 rays w, w + W, w + 2W, ...
// (W the grid's warps: neighbouring rays, which hit together, go to
// different warps), kBwdRounds at a time, their kinds loaded at once, and
// loads the next kBwdRounds kinds before it works on these.  acc has rows of acc_w
// floats (8 or 12), 16-byte aligned.  stage is the warp's row of the
// block's stage; sh_inst the instance variant's partial sums.
template <typename E, bool kV16, bool kSlab, bool kPlanes, bool kInst>
__device__ __forceinline__ void merged_rounds(const ResolveBwdParams& p,
                                              int acc_w, float* stage,
                                              float* sh_inst) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (kBwdThreads / 32) +
      (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) *
                          (kBwdThreads / 32);
  const auto kind_of = [&](long long round) {
    const long long i = (warp + round * warps) * 32 + lane;
    return i < p.rays ? p.kind[i] : 0;
  };
  int kinds[kBwdRounds];
  #pragma unroll
  for (int r = 0; r < kBwdRounds; ++r) kinds[r] = kind_of(r);
  #pragma unroll 1
  for (long long first = 0; (warp + first * warps) * 32 < p.rays;
       first += kBwdRounds) {
    int next[kBwdRounds];
    #pragma unroll
    for (int r = 0; r < kBwdRounds; ++r)
      next[r] = kind_of(first + kBwdRounds + r);
    #pragma unroll 1
    for (int r = 0; r < kBwdRounds; ++r) {
      const long long w0 = (warp + (first + r) * warps) * 32;
      if (w0 >= p.rays) break;                 // the whole warp
      backward_round<E, kV16, kSlab, kPlanes, kInst>(p, acc_w, w0, lane,
                                                     kinds[0], stage,
                                                     sh_inst);
      // the next round's kind to the front, in registers
      #pragma unroll
      for (int q = 0; q + 1 < kBwdRounds; ++q) kinds[q] = kinds[q + 1];
    }
    #pragma unroll
    for (int r = 0; r < kBwdRounds; ++r) kinds[r] = next[r];
  }
}

template <typename E, bool kV16, bool kSlab, bool kPlanes = false>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    resolve_bwd_merged_kernel(const ResolveBwdParams p, int acc_w) {
  __shared__ __align__(16) float stage[kBwdThreads / 32][2 * 96];
  merged_rounds<E, kV16, kSlab, kPlanes, false>(
      p, acc_w, stage[threadIdx.x >> 5], nullptr);
}

// The instances whose transforms' cotangents a block of the instance
// variant sums in shared memory (the scene march's kMaxInstances).
constexpr int kMaxInstanceGrads = 32;

// The instance variant (a scene's packed f32 or bf16 table): the merged
// kernel's rounds with kInst, a block's partial sums of the transforms'
// cotangents in shared memory, added into g_inst (f32 [I, kInstanceWords],
// zeroed by the caller) at the block's end, one f32 atomic a nonzero word.
template <typename E, bool kV16>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    resolve_bwd_instances_kernel(const ResolveBwdParams p, int acc_w,
                                 float* g_inst) {
  __shared__ __align__(16) float stage[kBwdThreads / 32][2 * 96];
  __shared__ float sh_inst[kMaxInstanceGrads * kInstanceWords];
  const int words = p.inst.count * kInstanceWords;
  for (int w = threadIdx.x; w < words; w += blockDim.x) sh_inst[w] = 0.0f;
  __syncthreads();
  merged_rounds<E, kV16, false, false, true>(p, acc_w,
                                             stage[threadIdx.x >> 5], sh_inst);
  __syncthreads();
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    if (sh_inst[w] != 0.0f) atomicAdd(g_inst + w, sh_inst[w]);
}

// The blocks of the merged kernel's grid (with kInst, the instance
// variant's): enough to cover the rays in one pass of kBwdRounds rounds a
// warp, at most as many as the SMs hold at once (found once a variant, on
// the card of its first launch).
template <typename E, bool kV16, bool kSlab, bool kPlanes, bool kInst = false>
long long merged_blocks(long long rays, cudaError_t& err) {
  const long long per_block = static_cast<long long>(kBwdThreads) *
                              kBwdRounds;
  const long long blocks = (rays + per_block - 1) / per_block;
  static const long long resident = [&] {
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = kInst ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, resolve_bwd_instances_kernel<E, kV16>,
                        kBwdThreads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm,
                        resolve_bwd_merged_kernel<E, kV16, kSlab, kPlanes>,
                        kBwdThreads, 0);
    return static_cast<long long>(max(per_sm, 1)) * sms;
  }();
  return blocks < resident ? blocks : resident;
}

template <typename E, bool kV16, bool kSlab, bool kPlanes = false>
cudaError_t launch_merged(const ResolveBwdParams& p, int acc_w,
                          cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const long long blocks =
      merged_blocks<E, kV16, kSlab, kPlanes>(p.rays, err);
  if (err != cudaSuccess) return err;
  resolve_bwd_merged_kernel<E, kV16, kSlab, kPlanes>
      <<<static_cast<unsigned>(blocks), kBwdThreads, 0, s>>>(p, acc_w);
  return cudaGetLastError();
}

template <typename E, bool kV16>
cudaError_t launch_instances(const ResolveBwdParams& p, int acc_w,
                             float* g_inst, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const long long blocks =
      merged_blocks<E, kV16, false, false, true>(p.rays, err);
  if (err != cudaSuccess) return err;
  resolve_bwd_instances_kernel<E, kV16>
      <<<static_cast<unsigned>(blocks), kBwdThreads, 0, s>>>(p, acc_w,
                                                             g_inst);
  return cudaGetLastError();
}

// One launch of the forward: design 0 the first design, 1 the redesign,
// each one thread a ray over the whole grid.
template <typename E, bool kV16, bool kPlanes>
void launch_forward(const ResolveParams& p, int design, cudaStream_t s) {
  if (design == 0)
    resolve_kernel<E, kV16, kPlanes>
        <<<static_cast<unsigned>((p.rays + 255) / 256), 256, 0, s>>>(p);
  else
    resolve_lean_kernel<E, kV16, kPlanes>
        <<<static_cast<unsigned>((p.rays + kResolveThreads - 1) /
                                 kResolveThreads),
           kResolveThreads, 0, s>>>(p);
}

}  // namespace

// The fused resolve.  bf16 1 reads the corner table as bf16 bits, else as
// f32; v16 1 takes the 16-byte load path (the caller checks that the rows
// and the table's base are 16-byte aligned).  The table has cx rows in x,
// row x holding cell x0 + x (a scene's: x0 0, cx cc; one rank's slab of a
// slab-sharded volume: its own rows, x0 the slab's first plane), and cc in y
// and z.  planes 1 reads a slab's f32 voxel planes [cx, cc + 1, cc + 1]
// from ``corners`` instead (plane x holding global plane x0 + x; bf16 0,
// v16 0).  design 0 runs the first design (resolve_kernel), 1 the redesign
// (resolve_lean_kernel).  Returns cudaGetLastError().
extern "C" int vrt_resolve_scene(
    const float* o_w, const float* d_w, const int32_t* winner,
    const int32_t* kind, const float* t, const int32_t* cell,
    const float* face, const int32_t* inst_volume, const float* inst_pos,
    const float* inst_rot, const float* inst_scale, int n_inst,
    const int32_t* n, const float* cell_size, const float* extends,
    const void* corners, int cc, int ch, int bf16, int v16, int x0, int cx,
    long long rays, float* t_out, float* normal, uint8_t* unlit, int planes,
    int design, void* stream) {
  if (n_inst < 1 || ch < 8 || design < 0 || design > 1 ||
      (planes && (bf16 || v16 || cx < 1)))
    return cudaErrorInvalidValue;
  const ResolveParams p{
      o_w, d_w, winner, kind, t, cell, face,
      Instances{inst_volume, inst_pos, inst_rot, inst_scale, nullptr, n_inst},
      Tables{n, cell_size, extends, nullptr, corners, nullptr, cc, ch},
      rays, t_out, normal, unlit, x0, cx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes) launch_forward<float, false, true>(p, design, s);
  else if (bf16 && v16) launch_forward<uint16_t, true, false>(p, design, s);
  else if (bf16) launch_forward<uint16_t, false, false>(p, design, s);
  else if (v16) launch_forward<float, true, false>(p, design, s);
  else launch_forward<float, false, false>(p, design, s);
  return static_cast<int>(cudaGetLastError());
}

// The backward.  g_o_w and g_d_w (both or neither) and
// acc may be null: that output is then skipped.  acc is an f32 buffer the
// caller zeroed, with a row of acc_w floats for each row of the table (read
// only with acc).  merged 1 takes the redesign (resolve_bwd_merged_kernel),
// whose acc_w is 8 or 12 and whose acc, g_o_w and g_d_w are 16-byte aligned;
// merged 0 the first design (resolve_bwd_kernel), whose acc_w is ch.  bf16,
// v16, x0 and cx as above: a table whose x rows are not the scene's (x0 0, cx
// cc) takes the kSlab variants, which read f32 tables only.  planes 1 (the
// merged kernel only) reads a slab's planes as vrt_resolve_scene does, and
// acc is the f32 gradient of the planes' shape (acc_w is not read).
// g_inst, last, null but in the instance variant (merged 1, a scene's
// table, at most kMaxInstanceGrads instances): the f32 [n_inst,
// kInstanceWords] accumulator of the instance transforms' cotangents, zeroed
// by the caller.  Returns cudaGetLastError().
extern "C" int vrt_resolve_scene_bwd(
    const float* o_w, const float* d_w, const int32_t* winner,
    const int32_t* kind, const float* t, const int32_t* cell,
    const float* g_t, const float* g_normal, const int32_t* inst_volume,
    const float* inst_pos, const float* inst_rot, const float* inst_scale,
    int n_inst, const int32_t* n, const float* cell_size,
    const float* extends, const void* corners, int cc, int ch, int bf16,
    int v16, int x0, int cx, long long rays, float* g_o_w, float* g_d_w,
    float* acc, int acc_w, int merged, int planes, void* stream,
    float* g_inst) {
  if (n_inst < 1 || ch < 8 || (g_o_w == nullptr) != (g_d_w == nullptr))
    return cudaErrorInvalidValue;
  const bool slab = planes || x0 != 0 || cx != cc;
  if (slab && (bf16 || cx < 1)) return cudaErrorInvalidValue;
  if (g_inst != nullptr && (!merged || slab || n_inst > kMaxInstanceGrads))
    return cudaErrorInvalidValue;
  if (planes && (!merged || v16)) return cudaErrorInvalidValue;
  if (planes) acc_w = 8;
  const auto misaligned = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 != 0;
  };
  if (merged ? (acc != nullptr && acc_w != 8 && acc_w != 12) ||
                   misaligned(acc) || misaligned(g_o_w) || misaligned(g_d_w)
             : acc != nullptr && acc_w != ch)
    return cudaErrorInvalidValue;
  const ResolveBwdParams p{
      o_w, d_w, winner, kind, t, cell, g_t, g_normal,
      Instances{inst_volume, inst_pos, inst_rot, inst_scale, nullptr, n_inst},
      Tables{n, cell_size, extends, nullptr, corners, nullptr, cc, ch},
      rays, g_o_w, g_d_w, acc, x0, cx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (merged) {
    cudaError_t err;
    if (g_inst != nullptr) {
      if (bf16)
        err = v16 ? launch_instances<uint16_t, true>(p, acc_w, g_inst, s)
                  : launch_instances<uint16_t, false>(p, acc_w, g_inst, s);
      else
        err = v16 ? launch_instances<float, true>(p, acc_w, g_inst, s)
                  : launch_instances<float, false>(p, acc_w, g_inst, s);
    } else if (planes)
      err = launch_merged<float, false, true, true>(p, acc_w, s);
    else if (slab)
      err = v16 ? launch_merged<float, true, true>(p, acc_w, s)
                : launch_merged<float, false, true>(p, acc_w, s);
    else if (bf16)
      err = v16 ? launch_merged<uint16_t, true, false>(p, acc_w, s)
                : launch_merged<uint16_t, false, false>(p, acc_w, s);
    else
      err = v16 ? launch_merged<float, true, false>(p, acc_w, s)
                : launch_merged<float, false, false>(p, acc_w, s);
    return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((rays + 255) / 256);
  if (slab) {
    if (v16) resolve_bwd_kernel<float, true, true><<<grid, 256, 0, s>>>(p);
    else resolve_bwd_kernel<float, false, true><<<grid, 256, 0, s>>>(p);
  } else if (bf16) {
    if (v16) resolve_bwd_kernel<uint16_t, true, false><<<grid, 256, 0, s>>>(p);
    else resolve_bwd_kernel<uint16_t, false, false><<<grid, 256, 0, s>>>(p);
  } else {
    if (v16) resolve_bwd_kernel<float, true, false><<<grid, 256, 0, s>>>(p);
    else resolve_bwd_kernel<float, false, false><<<grid, 256, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
