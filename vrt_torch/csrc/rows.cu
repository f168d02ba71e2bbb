// K3, the corner-row gather of resolve and of the voxel-colour sample, and
// its backward, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: vrt gathers these rows with jnp.take
// (vrt/march/isosurface.py make_stacked_corner_fetch, take_rows;
// vrt/render/renderer.py _voxel_color_sample) and differentiates the gather
// by XLA's transpose, a scatter-add.  The port's plain versions are
// gather_rows_reference and scatter_rows_reference in
// vrt_torch/kernels/rows.py.
//
//   gather   out[l, c] = float(table[idx[l], c])  for c < out_ch,
//            a zero row where idx[l] < 0
//   scatter  acc[idx[l], c] += g[l, c]            for c < out_ch, idx >= 0,
//            into an f32 [rows, ch] buffer the caller zeroed
//
// An index >= rows traps (the launch fails, as the plain versions' indexing
// raises or hits a device assert on it) instead of being read or written.
//
// What bounds them on this card: random reads of whole rows from tables of
// 9 to 53 MB (resolve's corner table of 2 x 64^3 or 2 x 128^3 cells, the
// colour table of 2 x 65^3 rows of 24 floats), and the writes of the
// [L, out_ch] f32 rows: bytes and load requests, not arithmetic.  The gather
// probe (vrt_torch/csrc/gather.cu, GP-B) measured that one 16-byte load per
// request beats one load per element by 1.3-2.8x on random rows, so:
//
// - gather: one thread per output row.  Rows whose size and base are
//   multiples of 16 bytes (8-channel f32 and bf16 corner tables, the
//   24-channel colour rows) are read with 16-byte loads; a 9-channel row
//   (36 B in f32, 18 B in bf16, the accel folded in as a 9th channel) is
//   not 16-byte aligned and is read one element at a time with __ldg.
//   bf16 widens to f32 exactly (a shift of its 16 bits).  The output row is
//   written as float4s (out_ch is a multiple of 4).
// - scatter: coalesced reads of g, f32 atomics into the row.  A zero
//   cotangent adds nothing and is skipped (x + 0 == x, and +0 + -0 == +0),
//   which drops the lanes whose pixels the loss does not see.  Where the
//   rows of g and of acc and the base of g are multiples of 16 bytes (the
//   24-float colour rows) one thread takes four channels: one float4 read,
//   nothing issued when all four are zero, else one 16-byte vector
//   reduction (red.global.add.v4.f32, new with sm_90), a quarter of the
//   threads and of the atomic requests.  Other rows (8 of 9 channels) take
//   one thread and one scalar atomicAdd per element.  Atomics add in
//   another order on every run, so the result agrees with an exact sum to
//   rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

struct GatherParams {
  const void* table;
  const int32_t* idx;
  float* out;
  long long rows;
  long long lanes;
  int ch;       // channels per table row
  int out_ch;   // channels gathered, a multiple of 4, <= ch
};

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t b) {
  return __uint_as_float(b << 16);
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return bf16_bits_to_f32(__ldg(p));
}

// E is float (f32 table) or uint16_t (the bits of a bf16 table).
template <typename E, bool kV16>
__global__ void __launch_bounds__(kBlock) gather_rows_kernel(
    const GatherParams p) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= p.lanes) return;
  float4* out = reinterpret_cast<float4*>(p.out + l * p.out_ch);
  const int quads = p.out_ch / 4;
  const int i = p.idx[l];
  if (i >= p.rows) __trap();
  if (i < 0) {
    for (int q = 0; q < quads; ++q) out[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const E* row = static_cast<const E*>(p.table) +
                 static_cast<long long>(i) * p.ch;
  if (kV16) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    if (sizeof(E) == 4) {
      for (int q = 0; q < quads; ++q) {
        const uint4 v = __ldg(src + q);
        out[q] = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                             __uint_as_float(v.z), __uint_as_float(v.w));
      }
    } else {
      for (int q = 0; q < quads; q += 2) {
        const uint4 v = __ldg(src + q / 2);
        out[q] = make_float4(bf16_bits_to_f32(v.x & 0xffffu),
                             __uint_as_float(v.x & 0xffff0000u),
                             bf16_bits_to_f32(v.y & 0xffffu),
                             __uint_as_float(v.y & 0xffff0000u));
        out[q + 1] = make_float4(bf16_bits_to_f32(v.z & 0xffffu),
                                 __uint_as_float(v.z & 0xffff0000u),
                                 bf16_bits_to_f32(v.w & 0xffffu),
                                 __uint_as_float(v.w & 0xffff0000u));
      }
    }
  } else {
    for (int q = 0; q < quads; ++q) {
      const E* e = row + 4 * q;
      out[q] = make_float4(load_f32(e), load_f32(e + 1), load_f32(e + 2),
                           load_f32(e + 3));
    }
  }
}

struct ScatterParams {
  const float* grad;   // [lanes, out_ch]
  const int32_t* idx;  // [lanes]
  float* acc;          // [rows, ch]
  long long rows;
  long long lanes;
  int ch;
  int out_ch;
};

__global__ void __launch_bounds__(kBlock) scatter_rows_kernel(
    const ScatterParams p) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= p.lanes * p.out_ch) return;
  const long long l = e / p.out_ch;
  const int c = static_cast<int>(e - l * p.out_ch);
  const int i = __ldg(p.idx + l);
  if (i >= p.rows) __trap();
  if (i < 0) return;
  const float g = p.grad[e];
  if (g != 0.0f) atomicAdd(p.acc + static_cast<long long>(i) * p.ch + c, g);
}

// The 16-byte path: thread e takes channels 4 * (e % quads) .. + 3 of lane
// e / quads.  The caller checks that out_ch and ch are multiples of 4 and
// that grad is 16-byte aligned (acc is, as a fresh allocation).
__global__ void __launch_bounds__(kBlock) scatter_rows_v4_kernel(
    const ScatterParams p) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int quads = p.out_ch / 4;
  if (e >= p.lanes * quads) return;
  const long long l = e / quads;
  const int c = 4 * static_cast<int>(e - l * quads);
  const int i = __ldg(p.idx + l);
  if (i >= p.rows) __trap();
  if (i < 0) return;
  const float4 g = reinterpret_cast<const float4*>(p.grad)[e];
  if (g.x == 0.0f && g.y == 0.0f && g.z == 0.0f && g.w == 0.0f) return;
  float* dst = p.acc + static_cast<long long>(i) * p.ch + c;
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(dst), "f"(g.x), "f"(g.y), "f"(g.z), "f"(g.w)
               : "memory");
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

}  // namespace

// The gather.  elem_bytes 4 (f32) or 2 (bf16); v16 1 takes the 16-byte
// load path (the caller checks that rows, the gathered prefix and the base
// are 16-byte aligned).  Returns cudaGetLastError().
extern "C" int vrt_gather_rows(const void* table, const int32_t* idx,
                               float* out, long long rows, long long lanes,
                               int ch, int out_ch, int elem_bytes, int v16,
                               void* stream) {
  if (out_ch % 4 != 0 || out_ch > ch || (elem_bytes != 4 && elem_bytes != 2))
    return cudaErrorInvalidValue;
  const GatherParams p{table, idx, out, rows, lanes, ch, out_ch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(lanes);
  if (elem_bytes == 4) {
    if (v16) gather_rows_kernel<float, true><<<grid, kBlock, 0, s>>>(p);
    else gather_rows_kernel<float, false><<<grid, kBlock, 0, s>>>(p);
  } else {
    if (v16) gather_rows_kernel<uint16_t, true><<<grid, kBlock, 0, s>>>(p);
    else gather_rows_kernel<uint16_t, false><<<grid, kBlock, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The scatter: acc[idx[l], c] += grad[l, c] for c < out_ch.  v4 1 takes
// the 16-byte path (the caller checks that ch and out_ch are multiples of 4
// and that grad and acc are 16-byte aligned).  Returns cudaGetLastError().
extern "C" int vrt_scatter_rows(const float* grad, const int32_t* idx,
                                float* acc, long long rows, long long lanes,
                                int ch, int out_ch, int v4, void* stream) {
  if (out_ch > ch || (v4 && (ch % 4 != 0 || out_ch % 4 != 0)))
    return cudaErrorInvalidValue;
  const ScatterParams p{grad, idx, acc, rows, lanes, ch, out_ch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v4)
    scatter_rows_v4_kernel<<<grid_for(lanes * (out_ch / 4)), kBlock, 0, s>>>(
        p);
  else
    scatter_rows_kernel<<<grid_for(lanes * out_ch), kBlock, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
