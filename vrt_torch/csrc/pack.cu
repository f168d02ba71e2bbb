// The corner table's pack and its backward, for Hopper (sm_90a).
//
// They replace no Pallas kernel: vrt packs the table with eight jnp slices
// of the SDF, a cast and a stack (vrt/march/types.py pack_cell_corners)
// inside its jitted fit step (vrt/diff/fit.py rebuild_accel, graft_params),
// where XLA fuses them into one loop and differentiates them by the slices'
// transpose.  Eager PyTorch runs the same lines as eight strided copies, a
// cast each and a cat, and their backward as eight zero-filled buffers
// summed.  The plain versions are
// vrt_torch/march/types.py pack_cell_corners_reference and
// vrt_torch/kernels/pack.py pack_corners_backward_reference.
//
//   pack      table[v,x,y,z,j] = T(sdf[v, x+dx_j, y+dy_j, z+dz_j]), j < 8, in
//             CORNERS order (dx_j, dy_j, dz_j) = (j & 1, j >> 1 & 1, j >> 2 & 1),
//             and with a 9th channel table[v,x,y,z,8] = T(a), a the packed
//             accel of the cell, its skip clamped to 127 in bf16
//             ((min(a >> 1, 127) << 1) | (a & 1), exact in 8 bits)
//   backward  g_sdf[v,x,y,z] = 0 + g[cell of corner 7] + ... + g[corner 0],
//             in f32, corner 7 first as autograd adds the slices' cotangents,
//             over the corners whose cell is in the table (the 9th channel
//             has no cotangent in the SDF)
//
// T is f32 or bf16; f32 -> bf16 rounds to nearest even, as torch's cast does.
//
// What bounds them: bytes.  config4's 257^3 bf16 table: the pack reads the
// 68 MB SDF and writes the 268 MB table, the backward reads the table's
// cotangent and writes the SDF's, 0.1 ms each at 3.35 TB/s, against a cast
// or an add an element.  The first designs (pack_kernel, pack_bwd_kernel):
// one thread a cell (the pack) or a voxel (the backward) from a flat 64-bit
// index, neighbouring threads on neighbouring z, so that the eight corner
// reads of a warp are eight coalesced spans that the caches share among
// neighbouring cells; a bf16 row of 8 is one 16-byte store and an f32 row
// of 8 two, a 9-channel row (18 or 36 bytes, not 16-byte aligned) nine
// scalar stores.  The backward gathers its at most 8 terms, so it needs no
// atomics and adds in a fixed order.  The fit step's pack is now the accel
// rebuild's (csrc/accel.cu); pack_kernel packs a table with a given accel.
//
// The backward's redesign (pack_bwd_tiled_kernel): the first design reads
// its 8 terms as 2- or 4-byte scalars at the row's stride, so a warp asks
// the caches for 8x the sectors it uses, and spends its instructions on
// 64-bit divisions and bound checks.  Here a block owns a 64 (z; 32 in
// f32) x 8 (y) column of voxels over up to 16 x-planes (3-D grid, 32-bit
// coordinates) and walks it along x.  Each cell plane that touches the
// column (9 y rows from y0-1, z0-1 on) is read once as coalesced 16-byte
// words, the next plane's words in flight while a plane's voxels add up,
// and stored channel by channel into a ring of three planes in shared
// memory, zero outside the volume.  Each voxel then adds its 8 terms from
// there, corner 7 first, with no bound checks (a zero adds nothing to a
// sum that starts at +0.0), one barrier a plane: the same adds in the same
// order as the first design, so the two are bit-equal.  A 9-channel row is
// no 16-byte multiple, so a y row's words start A cells early (A = 4 for
// f32, 8 for bf16: 144 bytes).
//
// Which design runs (vrt_pack_corners_bwd's design 2, the default): the
// tiled kernel where its words align (the side a multiple of A, the
// cotangent on a 16-byte boundary) and its grid fills the card with at
// least one wave of resident blocks; else the first design.  Below a wave
// its blocks walk their planes in sequence on a card they leave part idle:
// config6's two 65^3 volumes (256 blocks) run faster on the first design.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 256;

struct PackParams {
  const float* sdf;      // [V, n, n, n]
  const int32_t* accel;  // [V, c, c, c], with a 9th channel
  void* table;           // [V, c, c, c, K] f32 or bf16
  long long cells;       // V c^3
  int c;                 // cells a side; n = c + 1
};

struct PackBwdParams {
  const void* g;         // [V, c, c, c, K] f32 or bf16
  float* g_sdf;          // [V, n, n, n]
  long long voxels;      // V n^3
  int c;
};

// the redesigned backward's block: 32 (z) x 8 (y) threads walking up to
// 16 x-planes, each thread one voxel of a plane every 32 along z
constexpr int kThreadsZ = 32, kColY = 8, kMaxChunkX = 16;

struct PackBwdTiledParams {
  const void* g;         // [V, c, c, c, K] f32 or bf16
  float* g_sdf;          // [V, n, n, n]
  int c;
  int chunk_x;           // x-planes a block
  int chunks_x;          // x chunks a volume
};

// f32 -> bf16 bits, round to nearest even; a NaN becomes the quiet NaN.
__device__ __forceinline__ uint16_t to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <int K, bool kBf16>
__global__ void __launch_bounds__(kBlock) pack_kernel(const PackParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (i >= p.cells) return;
  const long long c = p.c, n = c + 1;
  const long long z = i % c, y = (i / c) % c, x = (i / (c * c)) % c;
  const long long v = i / (c * c * c);
  const float* s = p.sdf + ((v * n + x) * n + y) * n + z;
  float vals[8];
  for (int j = 0; j < 8; ++j)
    vals[j] = __ldg(s + ((j & 1) * n + ((j >> 1) & 1)) * n + ((j >> 2) & 1));
  float extra = 0.0f;
  if (K == 9) {
    int a = __ldg(p.accel + i);
    if (kBf16) a = (min(a >> 1, 127) << 1) | (a & 1);
    extra = static_cast<float>(a);
  }
  if (kBf16) {
    uint16_t* row = static_cast<uint16_t*>(p.table) + i * K;
    if (K == 8) {
      uint32_t w[4];
      for (int e = 0; e < 4; ++e)
        w[e] = static_cast<uint32_t>(to_bf16(vals[2 * e])) |
               (static_cast<uint32_t>(to_bf16(vals[2 * e + 1])) << 16);
      *reinterpret_cast<uint4*>(row) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int j = 0; j < 8; ++j) row[j] = to_bf16(vals[j]);
      row[8] = to_bf16(extra);
    }
  } else {
    float* row = static_cast<float*>(p.table) + i * K;
    if (K == 8) {
      float4* r4 = reinterpret_cast<float4*>(row);
      r4[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
      r4[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
    } else {
      for (int j = 0; j < 8; ++j) row[j] = vals[j];
      row[8] = extra;
    }
  }
}

template <int K, bool kBf16>
__global__ void __launch_bounds__(kBlock) pack_bwd_kernel(
    const PackBwdParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (i >= p.voxels) return;
  const long long c = p.c, n = c + 1;
  const long long z = i % n, y = (i / n) % n, x = (i / (n * n)) % n;
  const long long v = i / (n * n * n);
  float sum = 0.0f;
  for (int j = 7; j >= 0; --j) {
    const long long cx = x - (j & 1), cy = y - ((j >> 1) & 1),
                    cz = z - ((j >> 2) & 1);
    if (cx < 0 || cx >= c || cy < 0 || cy >= c || cz < 0 || cz >= c)
      continue;
    const long long e = (((v * c + cx) * c + cy) * c + cz) * K + j;
    const float g =
        kBf16 ? __uint_as_float(static_cast<uint32_t>(__ldg(
                                    static_cast<const uint16_t*>(p.g) + e))
                                << 16)
              : __ldg(static_cast<const float*>(p.g) + e);
    sum = sum + g;
  }
  p.g_sdf[i] = sum;
}

// The tiled backward's units: 16-byte words.
template <int K, bool kBf16>
struct Tile {
  using T = typename std::conditional<kBf16, uint16_t, float>::type;
  // the column's voxels along z: 64 (2 a thread) in bf16, 32 in f32, so
  // that three planes fit 48 KB of shared memory
  static constexpr int kColZ = kBf16 ? 64 : 32;
  static constexpr int kEs = kBf16 ? 2 : 4;  // bytes an element
  static constexpr int kPer = 16 / kEs;      // elements a word
  // cells at which a 16-byte word boundary repeats: 1 for 8 channels, 4
  // for 9 f32 (144 bytes), 8 for 9 bf16 (144 bytes)
  static constexpr int kLead = K == 8 ? 1 : (kBf16 ? 8 : 4);
  static constexpr int kRows = kColY + 2;                // y0-1 .. y0+8
  static constexpr int kCols = kColZ + kLead + 1;  // z0-lead .. z0+kColZ
  // the words of a loaded y row (y0-1 .. y0+7), and the most of a thread
  static constexpr int kPerRow = (kColZ + kLead) * K / kPer;
  static constexpr int kUnits = (kColY + 1) * kPerRow;
  static constexpr int kMaxUnits = (kUnits + kBlock - 1) / kBlock;
};

// Three cell planes of a column in shared memory, channel by channel in
// the table's type: [x % 3][channel][y - y0 + 1][z - z0 + lead].  A cell
// outside the volume, or outside the rows and columns a plane loads, holds
// +0.0, which adds nothing to a sum that starts at +0.0 (such a sum is
// never -0.0): the sums skip no term and check no bound.
template <int K, bool kBf16>
struct Planes {
  using Tl = Tile<K, kBf16>;
  typename Tl::T v[3][8][Tl::kRows][Tl::kCols];
};

__device__ __forceinline__ float as_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ float as_f32(float f) { return f; }

// A thread's words of cell plane x of the column (v, y0, z0) into u: word
// t + i * threads is word q % kPerRow of row q / kPerRow (cell y0 - 1 + row),
// whose cells start at z0 - lead.  A word lies inside the volume or
// outside it whole (the side is a multiple of lead), and outside it is 0.
template <int K, bool kBf16>
__device__ __forceinline__ void fetch_plane(
    const PackBwdTiledParams& p, uint4* u, int v,
    int x, int y0, int z0, int t, int threads) {
  using Tl = Tile<K, kBf16>;
  const int c = p.c;
  for (int i = 0; i < Tl::kMaxUnits; ++i) {
    const int q = t + i * threads;
    u[i] = uint4{};
    if (q >= Tl::kUnits || x < 0 || x >= c) continue;
    const int r = q / Tl::kPerRow, k = q - r * Tl::kPerRow;
    const int y = y0 - 1 + r;
    const int z = z0 - Tl::kLead + k * Tl::kPer / K;  // the word's first cell
    if (y < 0 || y >= c || z < 0 || z >= c) continue;
    const long long first =
        ((static_cast<long long>(v) * c + x) * c + y) * c + z0 - Tl::kLead;
    u[i] = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const unsigned char*>(p.g) + first * K * Tl::kEs +
        static_cast<long long>(k) * sizeof(uint4)));
  }
}

// The words fetched by fetch_plane into slot `slot`, channel by channel
// (the 9th channel dropped).
template <int K, bool kBf16>
__device__ __forceinline__ void store_plane(
    Planes<K, kBf16>& sh, const uint4* u,
    int slot, int t, int threads) {
  using Tl = Tile<K, kBf16>;
  using T = typename Tl::T;
  for (int i = 0; i < Tl::kMaxUnits; ++i) {
    const int q = t + i * threads;
    if (q >= Tl::kUnits) continue;
    const int r = q / Tl::kPerRow, k = q - r * Tl::kPerRow;
    const T* e = reinterpret_cast<const T*>(&u[i]);
    for (int j = 0; j < Tl::kPer; ++j) {
      const int idx = k * Tl::kPer + j, cell = idx / K, ch = idx - cell * K;
      if (ch < 8) sh.v[slot][ch][r][cell] = e[j];
    }
  }
}

template <int K, bool kBf16>
__global__ void __launch_bounds__(kBlock) pack_bwd_tiled_kernel(
    const PackBwdTiledParams p) {
  using Tl = Tile<K, kBf16>;
  using T = typename Tl::T;
  __shared__ __align__(16) Planes<K, kBf16> sh;
  const int c = p.c, n = c + 1;
  const int v = blockIdx.z / p.chunks_x;
  const int x_begin = (blockIdx.z - v * p.chunks_x) * p.chunk_x;
  const int x_end = min(x_begin + p.chunk_x, c);
  const int x_last = x_end == c ? c : x_end - 1;  // the last chunk takes x = c
  const int y0 = blockIdx.y * kColY, z0 = blockIdx.x * Tl::kColZ;
  const int t = threadIdx.y * kThreadsZ + threadIdx.x, threads = kBlock;
  {  // zeros everywhere: the rows and columns no plane loads stay zero
    T* all = &sh.v[0][0][0][0];
    for (int i = t; i < static_cast<int>(sizeof(sh) / sizeof(T));
         i += threads)
      all[i] = T(0);
  }
  uint4 u[Tl::kMaxUnits];
  __syncthreads();
  int prev = (x_begin + 2) % 3, cur = x_begin % 3;  // the slots of x-1, x
  fetch_plane<K, kBf16>(p, u, v, x_begin - 1, y0, z0, t, threads);
  store_plane<K, kBf16>(sh, u, prev, t, threads);
  fetch_plane<K, kBf16>(p, u, v, x_begin, y0, z0, t, threads);
  store_plane<K, kBf16>(sh, u, cur, t, threads);
  __syncthreads();
  // this thread's voxels in a plane: (y, z) for z every 32 of the column,
  // and y = c or z = c where it holds the volume's last cell along that axis
  const int y = y0 + threadIdx.y;
  const int ny = y < c ? (y == c - 1 ? 2 : 1) : 0;
  for (int x = x_begin; x <= x_last; ++x) {
    const int next = 3 - prev - cur;  // the slot of x + 1 (x - 2's)
    // plane x + 1's words in flight while plane x's voxels add up
    if (x < x_last)
      fetch_plane<K, kBf16>(p, u, v, x + 1, y0, z0, t, threads);
#pragma unroll
    for (int h = 0; h < Tl::kColZ / kThreadsZ; ++h) {
      const int zc = threadIdx.x + h * kThreadsZ, z = z0 + zc;
      const int nz = z < c ? (z == c - 1 ? 2 : 1) : 0;
      for (int a = 0; a < ny; ++a) {
        for (int b = 0; b < nz; ++b) {
          const int r = threadIdx.y + a + 1, col = zc + b + Tl::kLead;
          float sum = 0.0f;
#pragma unroll
          for (int j = 7; j >= 0; --j)
            sum = sum + as_f32(sh.v[(j & 1) ? prev : cur][j]
                                   [r - ((j >> 1) & 1)][col - ((j >> 2) & 1)]);
          p.g_sdf[((static_cast<long long>(v) * n + x) * n + y + a) * n + z +
                  b] = sum;
        }
      }
    }
    if (x < x_last) store_plane<K, kBf16>(sh, u, next, t, threads);
    __syncthreads();
    prev = cur;
    cur = next;
  }
}

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

// The tiled backward's launch over V volumes of c cells a side.
struct TiledLaunch {
  PackBwdTiledParams p;
  dim3 grid;
};

TiledLaunch tiled_launch(const void* g, float* g_sdf, long long volumes,
                         int c, int bf16) {
  TiledLaunch l{};
  l.p.g = g;
  l.p.g_sdf = g_sdf;
  l.p.c = c;
  // x-planes a block: fewer on a small volume, so that its blocks still
  // fill the card
  l.p.chunk_x = c / 8 < 4 ? 4 : (c / 8 > kMaxChunkX ? kMaxChunkX : c / 8);
  l.p.chunks_x = (c + l.p.chunk_x - 1) / l.p.chunk_x;
  const int col_z = bf16 ? 64 : 32;
  l.grid = dim3((c + col_z - 1) / col_z, (c + kColY - 1) / kColY,
                static_cast<unsigned>(volumes * l.p.chunks_x));
  return l;
}

// Blocks of the tiled kernel resident on the current card at once: its
// multiprocessors times the blocks each holds (its shared memory and
// threads decide); 0 where the runtime cannot say.
template <int K, bool kBf16>
long long tiled_wave() {
  static long long wave = -1;  // the kernel and the card stay the same
  if (wave < 0) {
    int dev = 0, sms = 0, per = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, pack_bwd_tiled_kernel<K, kBf16>, kBlock, 0) != cudaSuccess)
      return 0;
    wave = static_cast<long long>(sms) * per;
  }
  return wave;
}

long long wave_of(int channels, int bf16) {
  if (channels == 8) return bf16 ? tiled_wave<8, true>() : tiled_wave<8, false>();
  return bf16 ? tiled_wave<9, true>() : tiled_wave<9, false>();
}

// The design vrt_pack_corners_bwd runs for `design` (0 the first design,
// 1 the tiled kernel, 2 the choice): the tiled kernel takes 16-byte words
// (a side that is a multiple of the cells at which a word boundary
// repeats, a cotangent on a 16-byte boundary) and at most 65,535 x-chunks;
// the choice takes it where its grid is at least one wave of the card.
int design_of(const void* g, long long volumes, int c, int channels,
              int bf16, int design) {
  if (design == 0) return 0;
  const int lead = channels == 8 ? 1 : (bf16 ? 8 : 4);
  if (c % lead != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0) return 0;
  const TiledLaunch l = tiled_launch(g, nullptr, volumes, c, bf16);
  if (volumes * l.p.chunks_x > 65535) return 0;
  if (design == 1) return 1;
  const long long grid =
      static_cast<long long>(l.grid.x) * l.grid.y * l.grid.z;
  const long long wave = wave_of(channels, bf16);
  return wave > 0 && grid >= wave ? 1 : 0;
}

}  // namespace

// The pack: sdf f32 [V, c+1, c+1, c+1]; accel int32 [V, c, c, c] (null
// without a 9th channel); table [V, c, c, c, channels] of f32 (bf16 = 0) or
// bf16 (bf16 = 1), on a 16-byte boundary.  Returns cudaGetLastError().
extern "C" int vrt_pack_corners(const float* sdf, const int32_t* accel,
                                void* table, long long volumes, int c,
                                int channels, int bf16, void* stream) {
  if (c < 1 || volumes < 1 || (channels != 8 && channels != 9) ||
      (channels == 9) != (accel != nullptr) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return cudaErrorInvalidValue;
  const PackParams p{sdf, accel, table,
                     volumes * static_cast<long long>(c) * c * c, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks(p.cells);
  if (channels == 8) {
    if (bf16) pack_kernel<8, true><<<grid, kBlock, 0, s>>>(p);
    else pack_kernel<8, false><<<grid, kBlock, 0, s>>>(p);
  } else {
    if (bf16) pack_kernel<9, true><<<grid, kBlock, 0, s>>>(p);
    else pack_kernel<9, false><<<grid, kBlock, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The pack's backward: g [V, c, c, c, channels] of f32 (bf16 = 0) or bf16
// (bf16 = 1), the table's cotangent; g_sdf f32 [V, c+1, c+1, c+1], every
// voxel written; design 0 the first design, 1 the tiled kernel where its
// words align, 2 the tiled kernel where they align and its grid fills the
// card (else the first design).  Returns the design launched (0 or 1), or
// -cudaGetLastError() when the launch failed.
extern "C" int vrt_pack_corners_bwd(const void* g, float* g_sdf,
                                    long long volumes, int c, int channels,
                                    int bf16, int design, void* stream) {
  if (c < 1 || volumes < 1 || (channels != 8 && channels != 9) ||
      design < 0 || design > 2)
    return -cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design_of(g, volumes, c, channels, bf16, design) == 1) {
    const TiledLaunch l = tiled_launch(g, g_sdf, volumes, c, bf16);
    const dim3 block(kThreadsZ, kColY);
    if (channels == 8 && bf16)
      pack_bwd_tiled_kernel<8, true><<<l.grid, block, 0, s>>>(l.p);
    else if (channels == 8)
      pack_bwd_tiled_kernel<8, false><<<l.grid, block, 0, s>>>(l.p);
    else if (bf16)
      pack_bwd_tiled_kernel<9, true><<<l.grid, block, 0, s>>>(l.p);
    else
      pack_bwd_tiled_kernel<9, false><<<l.grid, block, 0, s>>>(l.p);
    const cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? 1 : -static_cast<int>(err);
  }
  const long long n = c + 1;
  const PackBwdParams p{g, g_sdf, volumes * n * n * n, c};
  const unsigned grid = blocks(p.voxels);
  if (channels == 8) {
    if (bf16) pack_bwd_kernel<8, true><<<grid, kBlock, 0, s>>>(p);
    else pack_bwd_kernel<8, false><<<grid, kBlock, 0, s>>>(p);
  } else {
    if (bf16) pack_bwd_kernel<9, true><<<grid, kBlock, 0, s>>>(p);
    else pack_bwd_kernel<9, false><<<grid, kBlock, 0, s>>>(p);
  }
  return -static_cast<int>(cudaGetLastError());
}
