// The fit step's accel rebuild, for Hopper (sm_90a): the octree accel of
// an SDF, its u8 view and its corner table in two kernels.
//
// They replace no Pallas kernel: vrt rebuilds the accel with jnp inside its
// jitted fit step (vrt/diff/fit.py:77 rebuild_accel over
// vrt/volume/accel.py:41-92 build_accel and vrt/march/types.py:25
// pack_cell_corners), where XLA fuses the sign compares, the max-pools, the
// repeats and the pack into a few loops.  Eager PyTorch runs the same lines
// as some ninety launches over the cells (vrt_torch/volume/accel.py
// build_accel, march/types.py _accel_u8 and pack_cell_corners_reference:
// the plain versions).
//
//   pyramid   occ_L[v, X, Y, Z] = OR of the flags of the 2^L-cell block
//             (X, Y, Z), L = 1..levels, each level the 2x2x2 OR of the one
//             below; flag = the three-valued sign differs among the cell's
//             8 corners (a NaN corner differs from every corner; -0 and +0
//             are one sign)
//   rebuild   per cell: skip = the largest L <= levels whose level-L block
//             is free (0 if none; occupancy only grows up the pyramid, so
//             the walk up stops at the first occupied block), and writes
//             accel = (skip << 1) | flag (int32), its u8 view
//             ((min(skip, 127) << 1) | flag) and the corner table's row
//             table[v,x,y,z,j] = T(sdf[v, x+dx_j, y+dy_j, z+dz_j]), j < 8, in
//             CORNERS order (dx, dy, dz) = (j & 1, j >> 1 & 1, j >> 2 & 1),
//             with a 9th channel T(accel), its skip clamped to 127 in bf16
//
// T is f32 or bf16 (round to nearest even, as torch's cast).  Each output is
// optional: build_accel on the card writes the accel alone.
//
// What bounds them: bytes.  config4's 257^3 SDF (68 MB) is read by both;
// the rebuild writes the 67 MB accel, its 17 MB u8 view and the 268 MB bf16
// table: 0.126 ms at 3.35 TB/s.  The pyramid is 2.4 MB of u8 at C = 256 and
// stays in L2 for the rebuild.  The design: one thread a level-1 block (2x2x2
// cells), 32-bit coordinates from a 3-D grid (threads along z, C = 2^R, so
// the volume and the plane come from shifts, no division), the block's 27
// corners loaded at once and its 8 flags from their sign bits ORed along z,
// y and x; a warp covers 64 cells of a row.  The pyramid is one launch
// (pyramid_one_kernel): a persistent grid of one wave walks tiles of (4,
// 4, 32) level-1 blocks, a level-1 block's occupancy the OR of its 27
// corners' sign classes, writes level 1 and reduces levels 2 and 3 in
// shared memory, and the grid's last block (a ticket counter) reduces the
// levels above from level 3.  Its first design, the comparator now, takes
// the same tiles in its first launch, and each further launch 3 levels
// more from the level below (ceil(levels / 3) launches).  Staging a tile's
// SDF voxels with their halo in shared memory (each voxel loaded once a
// block) was slower on the H100 than these loads through L1.  The rebuild knows the level-1
// occupancy from its own 8 flags and walks the block's ancestors once for
// its 8 cells, every level's load at once (a chain of dependent loads cost
// as much as the rest of the kernel); its accel and u8 view go out as pairs
// along z, an 8-channel row as one (bf16) or two (f32) 16-byte stores, a
// 9-channel row (36 or 18 bytes) through shared memory as contiguous
// 16-byte stores, a plane of the block's rows at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 12;
// the pyramid's tile in cells of its input level (each side clipped to it)
constexpr int kTileX = 8, kTileY = 8, kTileZ = 32;

struct PyramidParams {
  const float* sdf;        // [V, s+1, s+1, s+1] (the first launch)
  const uint8_t* below;    // [V, s, s, s], level `base` (the others)
  uint8_t* level[3];       // levels base+1 .. base+count
  int log_s;               // the input level's side, s = 2^log_s
  int log_tx, log_ty, log_tz;  // the tile's sides (logs)
  int count;               // levels written, 1..3
};

struct PyramidOneParams {
  const float* sdf;                  // [V, c+1, c+1, c+1]
  uint8_t* level[kMaxLevels + 1];    // level[L]: [V, c>>L, c>>L, c>>L]
  unsigned int* ticket;              // the grid's counter (levels > 3)
  long long volumes;
  int log_c, levels;
  int log_tx, log_ty, log_tz;        // the tile in level-1 blocks (logs)
};

struct RebuildParams {
  const float* sdf;                        // [V, c+1, c+1, c+1]
  const uint8_t* level[kMaxLevels + 1];    // level[L]: [V, c>>L, ...]
  int32_t* accel;                          // [V, c, c, c] or null
  uint8_t* accel_u8;                       // [V, c, c, c] or null
  void* table;                             // [V, c, c, c, K] or null
  int log_c, levels;
};

// f32 -> bf16 bits, round to nearest even; a NaN becomes the quiet NaN.
__device__ __forceinline__ uint16_t to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// A table element of type T from f32.
template <bool kBf16>
struct Elem;
template <>
struct Elem<true> {
  using T = uint16_t;
  __device__ static T of(float f) { return to_bf16(f); }
};
template <>
struct Elem<false> {
  using T = float;
  __device__ static T of(float f) { return f; }
};

// The three-valued sign of a sample as one bit: positive 1, negative 2,
// zero (+0 or -0) 4, NaN 8.  A cell's flag is set where the OR of its 8
// corners' bits holds more than one class or a NaN (a NaN differs from
// every corner, itself included).
__device__ __forceinline__ uint32_t sign_bit(float f) {
  return f > 0.0f ? 1u : f < 0.0f ? 2u : f == 0.0f ? 4u : 8u;
}

__device__ __forceinline__ int flag_of(uint32_t m) {
  return (m & (m - 1u)) != 0u || (m & 8u) != 0u;
}

// The 27 corners of the 2x2x2 cells from `s` (voxel (x, y, z) of a volume
// of side n, x slowest) and the 8 cells' flags, the corners' sign bits
// ORed along z, then y, then x.
__device__ __forceinline__ void block_flags(const float* s, long long n,
                                            float f[3][3][3],
                                            int flag[2][2][2]) {
  uint32_t m[3][3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        f[i][j][k] = __ldg(s + (i * n + j) * n + k);
        m[i][j][k] = sign_bit(f[i][j][k]);
      }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) m[i][j][k] |= m[i][j][k + 1];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) m[i][j][k] |= m[i][j + 1][k];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        flag[i][j][k] = flag_of(m[i][j][k] | m[i + 1][j][k]);
}

// Levels 2.. of a tile in shared memory: `tile` holds level `first - 1`'s
// (1 << lx) x (1 << ly) x (1 << lz) entries of the tile at level-(first-1)
// origin (x0, y0, z0) of volume v; each step ORs 2x2x2 of them into the
// next level's entries, in shared memory and in `level[m]` (side
// `side >> m`), for `count` steps.
__device__ __forceinline__ void reduce_tile(uint8_t* tile, uint8_t* const* level,
                                            int count, int lx, int ly, int lz,
                                            int v, long long side, int x0,
                                            int y0, int z0, int t) {
  uint8_t* src = tile;
  uint8_t* dst = tile + (1 << (lx + ly + lz));
  // unrolled, so that level[m] is no dynamic index into the parameters
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (m >= count) break;
    --lx;
    --ly;
    --lz;
    x0 >>= 1;
    y0 >>= 1;
    z0 >>= 1;
    side >>= 1;
    if (t < (1 << (lx + ly + lz))) {
      const int k = t & ((1 << lz) - 1), j = (t >> lz) & ((1 << ly) - 1),
                i = t >> (ly + lz);
      const int sy = 2 << ly, sz = 2 << lz;  // the source's sides
      uint8_t o = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o |= src[((2 * i + (e & 1)) * sy + 2 * j + ((e >> 1) & 1)) * sz +
                 2 * k + (e >> 2)];
      dst[t] = o;
      level[m][((v * side + x0 + i) * side + y0 + j) * side + z0 + k] = o;
    }
    __syncthreads();
    src = dst;
    dst += 1 << (lx + ly + lz);
  }
}

// The pyramid's first launch: a tile of (4, 4, 32) level-1 blocks (2x2x2
// cells), each side clipped to level 1's; a thread takes (up to) two
// along x, their 27 corners each loaded at once, and a warp 64 cells of a
// row along z.  Level 1 from the blocks' 8 flags, levels 2 and 3 reduced in
// shared memory.
__global__ void __launch_bounds__(kThreads) pyramid_cells_kernel(
    const PyramidParams p) {
  __shared__ uint8_t occ[512 + 64 + 8];
  const int h = 1 << (p.log_s - 1);  // level 1's side
  const int tiles_x = p.log_s - 1 - p.log_tx;  // log of the tiles along x
  const int v = blockIdx.z >> tiles_x;
  const int x0 = (blockIdx.z & ((1 << tiles_x) - 1)) << p.log_tx;
  const int y0 = blockIdx.y << p.log_ty, z0 = blockIdx.x << p.log_tz;
  const int per = (1 << p.log_tx) / blockDim.z;  // blocks a thread along x
  const int by = y0 + threadIdx.y, bz = z0 + threadIdx.x;
  const long long n = 2 * h + 1;
  // unrolled, so that both blocks' 54 loads are in flight at once
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q >= per) break;
    const int tx = threadIdx.z * per + q, bx = x0 + tx;
    float f[3][3][3];
    int flag[2][2][2];
    block_flags(p.sdf + ((v * n + 2 * bx) * n + 2 * by) * n + 2 * bz, n, f,
                flag);
    int o = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) o |= flag[e >> 2][(e >> 1) & 1][e & 1];
    occ[(tx << (p.log_ty + p.log_tz)) + (threadIdx.y << p.log_tz) +
        threadIdx.x] = static_cast<uint8_t>(o);
    p.level[0][((v * static_cast<long long>(h) + bx) * h + by) * h + bz] =
        static_cast<uint8_t>(o);
  }
  __syncthreads();
  const int t =
      (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  reduce_tile(occ, p.level + 1, p.count - 1, p.log_tx, p.log_ty, p.log_tz, v,
              h, x0, y0, z0, t);
}

// The pyramid's further launches: levels base+1 .. base+count over a tile
// of (8, 8, 32) entries of level base, threads (z, y) walking its x planes.
__global__ void __launch_bounds__(kThreads) pyramid_kernel(
    const PyramidParams p) {
  __shared__ uint8_t occ[kTileX * kTileY * kTileZ + 256 + 32 + 4];
  const int ty = 1 << p.log_ty, tz = 1 << p.log_tz;
  const int s = 1 << p.log_s;
  const int tiles_x = p.log_s - p.log_tx;  // log of the tiles along x
  const int v = blockIdx.z >> tiles_x;
  const int x0 = (blockIdx.z & ((1 << tiles_x) - 1)) << p.log_tx;
  const int y0 = blockIdx.y << p.log_ty, z0 = blockIdx.x << p.log_tz;
  const int y = y0 + threadIdx.y, z = z0 + threadIdx.x;
  const uint8_t* col =
      p.below + ((static_cast<long long>(v) * s + x0) * s + y) * s + z;
  for (int x = 0; x < (1 << p.log_tx); ++x)
    occ[(x * ty + threadIdx.y) * tz + threadIdx.x] =
        __ldg(col + static_cast<long long>(x) * s * s) != 0;
  __syncthreads();
  reduce_tile(occ, p.level, p.count, p.log_tx, p.log_ty, p.log_tz, v, s, x0,
              y0, z0, threadIdx.y * tz + threadIdx.x);
}

// The pyramid in one launch (the default): a persistent grid, one wave of
// resident blocks, whose blocks walk the first design's tiles of (4, 4, 32)
// level-1 blocks (each side clipped to level 1's) and write levels 1..3 of
// each as its first launch does, a thread (up to) two level-1 blocks along
// x from their 45 corners.  A level-1 block is occupied where its 27
// corners hold more than one sign class or a NaN: the union of its 8
// cells' flags, because neighbouring cells share corners (a path between
// two corners of different classes crosses an edge of a cell whose ends
// differ), so a corner's sign class is ORed once a block and not once a
// cell.  Where levels > 3, each block takes a ticket once its tiles are
// out (a fence first), and the grid's last block copies level 3 into
// shared memory where it fits, reduces levels 4..levels there (each also
// written out), and resets the ticket.  A persistent grid takes one
// ticket and one fence a block, not one a tile.
constexpr int kPyramidMinBlocks = 4;      // blocks an SM: registers, grid
constexpr int kTailBytes = 40960;  // 40 KB: the last block's shared levels

// OR of the two u8 entries at `at` (an even offset) of a level held in
// shared memory or, written by other blocks, in device memory
__device__ __forceinline__ uint32_t pair_of(const uint8_t* at, bool shared) {
  return shared ? *reinterpret_cast<const uint16_t*>(at)
                : __ldcg(reinterpret_cast<const unsigned short*>(at));
}

__global__ void __launch_bounds__(kThreads, kPyramidMinBlocks)
    pyramid_one_kernel(const PyramidOneParams p) {
  __shared__ uint8_t occ[512 + 64 + 8];
  __shared__ __align__(16) uint8_t kept[kTailBytes];
  __shared__ int last;
  const int lh = p.log_c - 1, h = 1 << lh;  // level 1's side
  // logs of the tiles a side
  const int lx = lh - p.log_tx, ly = lh - p.log_ty, lz = lh - p.log_tz;
  const long long tiles = p.volumes << (lx + ly + lz);
  const int t =
      (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y * blockDim.z;
  const int per = (1 << p.log_tx) / blockDim.z;  // blocks a thread along x
  const long long n = 2 * h + 1;                  // voxels a side
  const int count = p.levels < 3 ? p.levels : 3;
  uint8_t* const lv[3] = {p.level[1], p.level[2], p.level[3]};
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x0 = static_cast<int>(tile >> (ly + lz)) & ((1 << lx) - 1);
    const int v = static_cast<int>(tile >> (lx + ly + lz));
    const int tx0 = x0 << p.log_tx;
    const int y0 = (static_cast<int>(tile >> lz) & ((1 << ly) - 1))
                   << p.log_ty;
    const int z0 = (static_cast<int>(tile) & ((1 << lz) - 1)) << p.log_tz;
    const int by = y0 + threadIdx.y, bz = z0 + threadIdx.x;
    // the sign classes of the thread's (2 per + 1) x planes of 3 x 3
    // corners, ORed a plane (all 45 loads at once)
    const float* s =
        p.sdf + ((v * n + 2 * (tx0 + threadIdx.z * per)) * n + 2 * by) * n +
        2 * bz;
    uint32_t plane[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      plane[i] = 0;
      if (i > 2 * per) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          plane[i] |= sign_bit(__ldg(s + (i * n + j) * n + k));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= per) break;
      const int tx = threadIdx.z * per + q, bx = tx0 + tx;
      const uint8_t o = static_cast<uint8_t>(
          flag_of(plane[2 * q] | plane[2 * q + 1] | plane[2 * q + 2]));
      occ[(tx << (p.log_ty + p.log_tz)) + (threadIdx.y << p.log_tz) +
          threadIdx.x] = o;
      lv[0][((v * static_cast<long long>(h) + bx) * h + by) * h + bz] = o;
    }
    __syncthreads();
    // levels 2 and 3 (it ends in a barrier: occ is free for the next tile)
    reduce_tile(occ, lv + 1, count - 1, p.log_tx, p.log_ty, p.log_tz, v, h,
                tx0, y0, z0, t);
  }
  if (p.levels <= 3) return;
  // the ticket: the last block to finish builds levels 4..levels (the
  // barrier orders the block's level writes before thread 0's fence, which
  // publishes them before its ticket, as a release)
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
    if (last) *p.ticket = 0;  // every block has taken its ticket
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const uint8_t* src = lv[2];
  bool src_shared = false;
  int used = 0;  // bytes of `kept` holding levels for the next
  const long long side3 = 1ll << (p.log_c - 3);
  const long long entries3 = p.volumes * side3 * side3 * side3;
  if (entries3 <= kTailBytes) {
    // level 3 into shared memory, in 16-byte words where they align
    const bool words = reinterpret_cast<uintptr_t>(lv[2]) % 16 == 0 &&
                       entries3 % 16 == 0;
    if (words) {
      for (int w = t; w < entries3 / 16; w += threads)
        reinterpret_cast<uint4*>(kept)[w] =
            __ldcg(reinterpret_cast<const uint4*>(lv[2]) + w);
    } else {
      for (int e = t; e < entries3; e += threads) kept[e] = __ldcg(lv[2] + e);
    }
    __syncthreads();
    src = kept;
    src_shared = true;
    used = static_cast<int>(entries3);
  }
  // unrolled, so that p.level[lvl] is no dynamic index into the parameters
#pragma unroll
  for (int lvl = 4; lvl <= kMaxLevels; ++lvl) {
    if (lvl > p.levels) break;
    const int ls = p.log_c - lvl;  // log of the level's side
    const int side = 1 << ls;
    const long long below = 2 << ls, entries = p.volumes << (3 * ls);
    uint8_t* out =
        used + entries <= kTailBytes ? kept + used : static_cast<uint8_t*>(0);
#pragma unroll 4
    for (long long u = t; u < entries; u += threads) {
      const long long vi = u >> (2 * ls);  // volume * side + i
      const int k = static_cast<int>(u) & (side - 1);
      const int j = static_cast<int>(u >> ls) & (side - 1);
      const long long i = vi & (side - 1), vol = vi >> ls;
      const uint8_t* at =
          src + ((vol * below + 2 * i) * below + 2 * j) * below + 2 * k;
      const uint32_t o = pair_of(at, src_shared) |
                         pair_of(at + below, src_shared) |
                         pair_of(at + below * below, src_shared) |
                         pair_of(at + below * below + below, src_shared);
      p.level[lvl][u] = o != 0;
      if (out) out[u] = o != 0;
    }
    __syncthreads();
    if (out) {
      src = out;
      src_shared = true;
      used += static_cast<int>(entries);
    } else {
      src = p.level[lvl];
      src_shared = false;
    }
  }
}

// One thread a level-1 block (2x2x2 cells), threads along z: its 27
// corners at once, the 8 flags, the block's skip from the walk up the
// pyramid (one for its 8 cells: a cell's skip is 0 where its level-1 block
// holds a surface, else the block's), the cells' accel and u8 view as
// pairs along z, and their table rows (K = 0: no table).
template <int K, bool kBf16>
__global__ void __launch_bounds__(kThreads) rebuild_kernel(
    const RebuildParams p) {
  using T = typename Elem<kBf16>::T;
  // a block's rows of one x plane for a 9-channel table: (2 ty) y rows of
  // (2 tz) cells
  __shared__ __align__(16) T rows[K == 9 ? 2 * kThreads * 2 * 9 : 1];
  const int c = 1 << p.log_c, lh = p.log_c - 1;  // level 1's side, log
  const int v = blockIdx.z >> lh, bx = blockIdx.z & ((1 << lh) - 1);
  const int by = blockIdx.y * blockDim.y + threadIdx.y;
  const int bz = blockIdx.x * blockDim.x + threadIdx.x;
  const int x = 2 * bx, y = 2 * by, z = 2 * bz;
  const long long n = c + 1;
  float f[3][3][3];
  int flag[2][2][2];
  block_flags(p.sdf + ((v * n + x) * n + y) * n + z, n, f, flag);
  int any = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) any |= flag[e >> 2][(e >> 1) & 1][e & 1];
  // the block's level-L ancestors, L = 2..levels, loaded at once; the skip
  // counts the free levels from 1 on (level 1 is `any`)
  uint8_t occ[kMaxLevels + 1];
#pragma unroll
  for (int lvl = 2; lvl <= kMaxLevels; ++lvl) {
    const int ls = p.log_c - lvl;  // log of the level's side
    occ[lvl] = 1;
    if (lvl <= p.levels)
      occ[lvl] = __ldg(p.level[lvl] +
                       ((((static_cast<long long>(v) << ls) + (x >> lvl))
                         << ls) + (y >> lvl) << ls) + (z >> lvl));
  }
  int skip = 0;
  bool free = p.levels >= 1 && !any;
  skip += free;
#pragma unroll
  for (int lvl = 2; lvl <= kMaxLevels; ++lvl) {
    free = free && occ[lvl] == 0;
    skip += free;
  }
  int a[2][2][2];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    a[e >> 2][(e >> 1) & 1][e & 1] =
        (skip << 1) | flag[e >> 2][(e >> 1) & 1][e & 1];
  const int view_skip = min(skip, 127) << 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long cell =
          ((static_cast<long long>(v) * c + x + i) * c + y + j) * c + z;
      if (p.accel)
        *reinterpret_cast<int2*>(p.accel + cell) =
            make_int2(a[i][j][0], a[i][j][1]);
      if (p.accel_u8)
        *reinterpret_cast<uint16_t*>(p.accel_u8 + cell) =
            static_cast<uint16_t>((view_skip | flag[i][j][0]) |
                                  ((view_skip | flag[i][j][1]) << 8));
    }
  if (K == 0 || p.table == nullptr) return;
  // cell (x+i, y+j, z+k)'s corner e is f[i + (e & 1)][j + (e >> 1 & 1)]
  // [k + (e >> 2)]
  if (K == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long cell =
            ((static_cast<long long>(v) * c + x + i) * c + y + j) * c + z;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float vals[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            vals[e] = f[i + (e & 1)][j + ((e >> 1) & 1)][k + (e >> 2)];
          if (kBf16) {
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              w[q] = static_cast<uint32_t>(to_bf16(vals[2 * q])) |
                     (static_cast<uint32_t>(to_bf16(vals[2 * q + 1])) << 16);
            reinterpret_cast<uint4*>(p.table)[cell + k] =
                make_uint4(w[0], w[1], w[2], w[3]);
          } else {
            float4* r4 = reinterpret_cast<float4*>(p.table) + 2 * (cell + k);
            r4[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
            r4[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
          }
        }
      }
    return;
  }
  // 9 channels: the accel as a 9th, its skip clamped to 127 in bf16
  const int tz = blockDim.x, ty = blockDim.y;
  const int seg = 2 * tz * 9 * static_cast<int>(sizeof(T));  // bytes a y row
  T* table = static_cast<T*>(p.table);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float extra = static_cast<float>(
            kBf16 ? view_skip | flag[i][j][k] : a[i][j][k]);
        T row[9];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          row[e] = Elem<kBf16>::of(
              f[i + (e & 1)][j + ((e >> 1) & 1)][k + (e >> 2)]);
        row[8] = Elem<kBf16>::of(extra);
        if (seg % 16 != 0) {  // a narrow volume: each row stored alone
          const long long cell =
              ((static_cast<long long>(v) * c + x + i) * c + y + j) * c + z +
              k;
#pragma unroll
          for (int e = 0; e < 9; ++e) table[cell * 9 + e] = row[e];
        } else {
          // row (2 * threadIdx.y + j) of the block, cell 2 * threadIdx.x + k
#pragma unroll
          for (int e = 0; e < 9; ++e)
            rows[((2 * threadIdx.y + j) * 2 * tz + 2 * threadIdx.x + k) * 9 +
                 e] = row[e];
        }
      }
    if (seg % 16 != 0) continue;
    __syncthreads();
    // plane x + i's (2 ty) y rows, each (2 tz) cells contiguous in the
    // table, in 16-byte words
    const int words = seg / 16, total = words * 2 * ty;
    const int t = threadIdx.y * tz + threadIdx.x;
    const long long first =
        ((static_cast<long long>(v) * c + x + i) * c +
         2 * blockIdx.y * ty) * c + 2 * blockIdx.x * tz;
    for (int u = t; u < total; u += tz * ty) {
      const int r = u / words, w = u - r * words;
      reinterpret_cast<uint4*>(table + (first + static_cast<long long>(r) *
                                                    c) * 9)[w] =
          reinterpret_cast<const uint4*>(rows)[r * words + w];
    }
    __syncthreads();
  }
}

// The one-launch pyramid's grid: the blocks of `threads` threads (a power
// of two up to kThreads) resident on the current card at once, one wave
// (the card stays the same); 0 where the runtime cannot say.
long long resident_blocks(int threads) {
  static long long wave[9] = {-1, -1, -1, -1, -1, -1, -1, -1, -1};
  int log = 0;
  while ((1 << log) < threads) ++log;
  if (log > 8) return 0;
  if (wave[log] < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pyramid_one_kernel, threads, 0) != cudaSuccess)
      return 0;
    wave[log] = static_cast<long long>(sms) * per_sm;
  }
  return wave[log];
}

}  // namespace

// The occupancy pyramid of sdf f32 [V, c+1, c+1, c+1], c = 2^log_c, levels
// 1..levels (levels <= log_c, <= 12) into `pyramid`, level after level,
// each [V, c >> L, c >> L, c >> L]: design 1 (the default) in one launch,
// `ticket` a zeroed 32-bit counter on the card that no other launch uses at
// once (read only where levels > 3; the launch leaves it zeroed), design 0
// (the first design) in ceil(levels / 3).  Returns the launches made or
// minus cudaGetLastError() where one failed.
extern "C" int vrt_accel_pyramid(const float* sdf, uint8_t* pyramid,
                                 long long volumes, int log_c, int levels,
                                 unsigned int* ticket, int design,
                                 void* stream) {
  if (volumes < 1 || log_c < 1 || levels < 0 || levels > log_c ||
      levels > kMaxLevels || (design != 0 && design != 1) ||
      (design == 1 && levels > 3 && ticket == nullptr))
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* level[kMaxLevels + 2] = {};
  uint8_t* at = pyramid;
  for (int lvl = 1; lvl <= levels; ++lvl) {
    level[lvl] = at;
    const long long side = 1ll << (log_c - lvl);
    at += volumes * side * side * side;
  }
  if (levels == 0) return 0;
  if (design == 1) {
    PyramidOneParams p{};
    p.sdf = sdf;
    for (int lvl = 1; lvl <= levels; ++lvl) p.level[lvl] = level[lvl];
    p.ticket = ticket;
    p.volumes = volumes;
    p.log_c = log_c;
    p.levels = levels;
    // the first design's first launch's tiles and threads
    const int lh = log_c - 1;
    p.log_tx = lh < 2 ? lh : 2;
    p.log_ty = lh < 2 ? lh : 2;
    p.log_tz = lh < 5 ? lh : 5;
    const dim3 block(1u << p.log_tz, 1u << p.log_ty,
                     p.log_tx > 0 ? 1u << (p.log_tx - 1) : 1u);
    // one wave of resident blocks, at most one a tile
    const long long tiles = volumes << (3 * lh - p.log_tx - p.log_ty -
                                        p.log_tz);
    const long long blocks = resident_blocks(block.x * block.y * block.z);
    if (blocks <= 0) {
      const cudaError_t err = cudaGetLastError();
      return -static_cast<int>(err != cudaSuccess
                                   ? err
                                   : cudaErrorInvalidConfiguration);
    }
    pyramid_one_kernel<<<static_cast<unsigned>(
                             tiles < blocks ? tiles : blocks),
                         block, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -static_cast<int>(err);
  }
  int launches = 0;
  for (int base = 0; base < levels; base += 3) {
    PyramidParams p{};
    p.sdf = sdf;
    p.below = level[base];
    p.log_s = log_c - base;
    p.count = levels - base < 3 ? levels - base : 3;
    for (int m = 0; m < p.count; ++m) p.level[m] = level[base + 1 + m];
    if (base == 0) {
      // tiles of level-1 blocks: (4, 4, 32), each side clipped to level
      // 1's; threads (z, y, x) with two blocks a thread along x
      const int lh = log_c - 1;
      p.log_tx = lh < 2 ? lh : 2;
      p.log_ty = lh < 2 ? lh : 2;
      p.log_tz = lh < 5 ? lh : 5;
      const dim3 grid(1u << (lh - p.log_tz), 1u << (lh - p.log_ty),
                      static_cast<unsigned>(volumes << (lh - p.log_tx)));
      const dim3 block(1u << p.log_tz, 1u << p.log_ty,
                       p.log_tx > 0 ? 1u << (p.log_tx - 1) : 1u);
      pyramid_cells_kernel<<<grid, block, 0, st>>>(p);
    } else {
      p.log_tx = p.log_s < 3 ? p.log_s : 3;
      p.log_ty = p.log_s < 3 ? p.log_s : 3;
      p.log_tz = p.log_s < 5 ? p.log_s : 5;
      const dim3 grid(1u << (p.log_s - p.log_tz), 1u << (p.log_s - p.log_ty),
                      static_cast<unsigned>(volumes << (p.log_s - p.log_tx)));
      const dim3 block(1u << p.log_tz, 1u << p.log_ty);
      pyramid_kernel<<<grid, block, 0, st>>>(p);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launches;
  }
  return launches;
}

// The rebuild over sdf f32 [V, c+1, c+1, c+1] and its pyramid (levels
// 1..levels, as vrt_accel_pyramid wrote it): accel int32 [V, c, c, c],
// accel_u8 [V, c, c, c], table [V, c, c, c, channels] of f32 (bf16 = 0) or
// bf16 (bf16 = 1) on a 16-byte boundary, each null where not wanted
// (channels 0: no table).  Returns cudaGetLastError().
extern "C" int vrt_accel_rebuild(const float* sdf, const uint8_t* pyramid,
                                 int32_t* accel, uint8_t* accel_u8,
                                 void* table, long long volumes, int log_c,
                                 int levels, int channels, int bf16,
                                 void* stream) {
  if (volumes < 1 || log_c < 1 || levels < 0 || levels > log_c ||
      levels > kMaxLevels || (volumes << (log_c - 1)) > 65535 ||
      (channels != 0 && channels != 8 && channels != 9) ||
      (channels != 0) != (table != nullptr) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return cudaErrorInvalidValue;
  RebuildParams p{};
  p.sdf = sdf;
  const uint8_t* at = pyramid;
  for (int lvl = 1; lvl <= levels; ++lvl) {
    p.level[lvl] = at;
    const long long side = 1ll << (log_c - lvl);
    at += volumes * side * side * side;
  }
  p.accel = accel;
  p.accel_u8 = accel_u8;
  p.table = table;
  p.log_c = log_c;
  p.levels = levels;
  // one thread a level-1 block: (32, 8) of them a block along z and y,
  // each side clipped to level 1's
  const int h = 1 << (log_c - 1);
  const int tz = h < 32 ? h : 32;
  const int ty = h < kThreads / tz ? h : kThreads / tz;
  const dim3 grid(h / tz, h / ty, static_cast<unsigned>(volumes * h));
  const dim3 block(tz, ty);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (channels == 0) rebuild_kernel<0, false><<<grid, block, 0, st>>>(p);
  else if (channels == 8 && bf16)
    rebuild_kernel<8, true><<<grid, block, 0, st>>>(p);
  else if (channels == 8) rebuild_kernel<8, false><<<grid, block, 0, st>>>(p);
  else if (bf16) rebuild_kernel<9, true><<<grid, block, 0, st>>>(p);
  else rebuild_kernel<9, false><<<grid, block, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
