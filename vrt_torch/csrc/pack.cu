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
// or an add an element.  The design: one thread a cell (the pack) or a voxel
// (the backward), neighbouring threads on neighbouring z, so that the eight
// corner reads of a warp are eight coalesced spans that the caches share
// among neighbouring cells; a bf16 row of 8 is one 16-byte store and an f32
// row of 8 two, a 9-channel row (18 or 36 bytes, not 16-byte aligned) nine
// scalar stores.  The backward gathers its at most 8 terms, so it needs no
// atomics and adds in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

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

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
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
// voxel written.  Returns cudaGetLastError().
extern "C" int vrt_pack_corners_bwd(const void* g, float* g_sdf,
                                    long long volumes, int c, int channels,
                                    int bf16, void* stream) {
  if (c < 1 || volumes < 1 || (channels != 8 && channels != 9))
    return cudaErrorInvalidValue;
  const long long n = c + 1;
  const PackBwdParams p{g, g_sdf, volumes * n * n * n, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks(p.voxels);
  if (channels == 8) {
    if (bf16) pack_bwd_kernel<8, true><<<grid, kBlock, 0, s>>>(p);
    else pack_bwd_kernel<8, false><<<grid, kBlock, 0, s>>>(p);
  } else {
    if (bf16) pack_bwd_kernel<9, true><<<grid, kBlock, 0, s>>>(p);
    else pack_bwd_kernel<9, false><<<grid, kBlock, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
