// The gather probe's three kernels for Hopper (sm_90a): GP-A, GP-B, GP-C.
//
// They replace the Pallas TPU gather probes of scripts/probe_gather.py,
// probe_gather2.py, probe_gather4.py and probe_gather5.py (19 functions
// that reach pl.pallas_call; vrt_torch/apps/probe_gather.py lists each
// with the kernel that takes its place).  All three are exact gathers: each
// output equals its plain-torch version in vrt_torch/kernels/gather.py bit
// for bit.  Indices that fall outside the table read 0 instead of faulting.
//
// GP-A, take_along_axis on a 2-D f32 table, along axis 0 or 1
//   (case_a, case_b, equal_gather_axis0/1, p1, p2, and looped k1, k1b).
//   One thread per output element with an __ldg read.  On the TPU these
//   were sublane or lane shuffles inside one VMEM tile; here a thread reads
//   its element from global memory, and the small tables stay in L1/L2, so
//   the kernel is bound by launch and load latency, not by bytes.
//
// GP-B, row gather out[r,:] = src[idx[r],:] for rows of W elements of 1, 2
//   or 4 bytes (case_c, case_d, case_d2, case_e, p3, p3b, p5, and looped
//   k2, k3; also the XLA-side row gathers those scripts timed).
//   Bound by random reads from device memory once the table is larger
//   than the 50 MB L2: each row costs at least one 32-byte sector.  Three
//   load paths, so the probe can tell them apart:
//   - "ldg":  one thread per element, scalar __ldg loads;
//   - "v16":  one thread per 16-byte chunk, 16-byte vector loads, for rows
//             whose size is a multiple of 16 bytes;
//   - "smem": the whole table (<= 227 KB) copied into each block's shared
//             memory, then read from there: the counterpart of a
//             VMEM-resident table (p5, k2).  case_d and case_d2 differ on
//             the TPU only by the table's memory space (HBM or VMEM); both
//             read global memory here.
//
// GP-C, one-hot gather out = onehot(idx, K) @ bf16(src), src K x 8, f32
//   accumulation (p4, and looped k4).  On the TPU this was the MXU's way to
//   gather.  On Hopper the same function is a gather of the bf16-rounded
//   row: every product but one is 0 * b and the sum is exact, so each
//   output is float(bf16(src[idx])) + 0 (a -0 sums to +0), except in a
//   column where another row holds an Inf or a NaN, where 0 * Inf makes the
//   matmul's sum NaN (and an index outside the table selects no row: 0, or
//   NaN in such a column).
//   The first design (onehot_kernel, kept as the probe's comparator) runs
//   the matmul on the tensor cores: one warp per 16 output rows, the
//   one-hot A fragments built in registers from the rows' indices, B (src
//   as bf16, 16 B per row, 8 KB at K = 512) staged in shared memory, and
//   mma.sync.m16n8k16 walking K in steps of 16: K/16 tensor-core ops per
//   16 rows, all to move one 16-byte row, bound by the rate of mma
//   instructions (2.8x src[idx]'s time at p4's shape on the H100).
//   The redesign (onehot_direct_kernel, the default) stages bf16(src) once
//   a block in shared memory as before, counting each column's non-finite
//   values while it does, then gives four threads each output row: a 4-byte
//   shared load of two channels a round, widened to f32, NaN where the
//   column's count says the matmul would give it.  The rounds, their order of sums
//   and the outputs equal the first design's bit for bit.
//
// The looped cases ("iters" > 0) take the index (idx + t) & mask in round
// t = 0 .. iters-1, as the Pallas fori_loops do, and either add the rounds
// into an f32 accumulator that starts at 0 in that order (sum), or store
// every round's rows over the last (last wins, k3; the stores are volatile
// so that every round's reads stay in the kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, a block's dynamic maximum

__device__ __forceinline__ int round_index(int i, int t, int mask) {
  return (i + t) & mask;
}

// ---- GP-A -----------------------------------------------------------------

struct TakeParams {
  const float* src;
  const int32_t* idx;
  float* out;
  int src_rows, src_cols;
  int out_rows, out_cols;
  int iters, mask;
};

template <int kAxis>
__device__ __forceinline__ float take_one(const TakeParams& p, int r, int c,
                                          int j) {
  if (kAxis == 0)
    return (j >= 0 && j < p.src_rows)
               ? __ldg(p.src + static_cast<long long>(j) * p.src_cols + c)
               : 0.0f;
  return (j >= 0 && j < p.src_cols)
             ? __ldg(p.src + static_cast<long long>(r) * p.src_cols + j)
             : 0.0f;
}

template <int kAxis>
__global__ void __launch_bounds__(kBlock) take_kernel(const TakeParams p) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(p.out_rows) * p.out_cols) return;
  const int r = static_cast<int>(e / p.out_cols);
  const int c = static_cast<int>(e - static_cast<long long>(r) * p.out_cols);
  const int i = p.idx[e];
  if (p.iters == 0) {
    p.out[e] = take_one<kAxis>(p, r, c, i);
    return;
  }
  float acc = 0.0f;
  for (int t = 0; t < p.iters; ++t)
    acc += take_one<kAxis>(p, r, c, round_index(i, t, p.mask));
  p.out[e] = acc;
}

// ---- GP-B -----------------------------------------------------------------

struct RowParams {
  const void* src;
  const int32_t* idx;
  void* out;
  long long src_rows;
  long long out_rows;
  int width;       // elements per row
  int iters, mask;
};

// One thread per output element.  E is the element type, or float for sum.
template <typename E, bool kSum>
__global__ void __launch_bounds__(kBlock) rows_ldg(const RowParams p) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= p.out_rows * p.width) return;
  const long long r = e / p.width;
  const int j = static_cast<int>(e - r * p.width);
  const E* src = static_cast<const E*>(p.src);
  E* out = static_cast<E*>(p.out);
  const int i0 = p.idx[r];
  auto fetch = [&](int i) -> E {
    return (i >= 0 && i < p.src_rows)
               ? __ldg(src + static_cast<long long>(i) * p.width + j)
               : E(0);
  };
  if (p.iters == 0) {
    out[e] = fetch(i0);
  } else if (kSum) {
    float acc = 0.0f;
    for (int t = 0; t < p.iters; ++t)
      acc += static_cast<float>(fetch(round_index(i0, t, p.mask)));
    out[e] = static_cast<E>(acc);
  } else {
    volatile E* dst = out + e;
    for (int t = 0; t < p.iters; ++t) *dst = fetch(round_index(i0, t, p.mask));
  }
}

__device__ __forceinline__ void store_volatile(uint4* p, uint4 v) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// One thread per 16-byte chunk of a row (row bytes a multiple of 16).
// Sum mode adds the chunk as four f32 lanes.
template <bool kSum>
__global__ void __launch_bounds__(kBlock) rows_v16(const RowParams p,
                                                   int chunks) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= p.out_rows * chunks) return;
  const long long r = e / chunks;
  const int j = static_cast<int>(e - r * chunks);
  const uint4* src = static_cast<const uint4*>(p.src);
  uint4* out = static_cast<uint4*>(p.out);
  const int i0 = p.idx[r];
  auto fetch = [&](int i) -> uint4 {
    return (i >= 0 && i < p.src_rows)
               ? __ldg(src + static_cast<long long>(i) * chunks + j)
               : make_uint4(0u, 0u, 0u, 0u);
  };
  if (p.iters == 0) {
    out[e] = fetch(i0);
  } else if (kSum) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < p.iters; ++t) {
      const uint4 v = fetch(round_index(i0, t, p.mask));
      a[0] += __uint_as_float(v.x);
      a[1] += __uint_as_float(v.y);
      a[2] += __uint_as_float(v.z);
      a[3] += __uint_as_float(v.w);
    }
    out[e] = make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                        __float_as_uint(a[2]), __float_as_uint(a[3]));
  } else {
    for (int t = 0; t < p.iters; ++t)
      store_volatile(out + e, fetch(round_index(i0, t, p.mask)));
  }
}

// The table in each block's shared memory; a grid-stride loop over the
// output elements, so each block copies the table once.
template <typename E, bool kSum>
__global__ void __launch_bounds__(kBlock) rows_smem(const RowParams p,
                                                    int table_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* src = static_cast<const unsigned char*>(p.src);
  if (table_bytes % 4 == 0) {
    for (int b = threadIdx.x; b < table_bytes / 4; b += blockDim.x)
      reinterpret_cast<uint32_t*>(smem)[b] =
          __ldg(reinterpret_cast<const uint32_t*>(src) + b);
  } else {
    for (int b = threadIdx.x; b < table_bytes; b += blockDim.x)
      smem[b] = __ldg(src + b);
  }
  __syncthreads();
  const E* tab = reinterpret_cast<const E*>(smem);
  E* out = static_cast<E*>(p.out);
  const long long total = p.out_rows * p.width;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / p.width;
    const int j = static_cast<int>(e - r * p.width);
    const int i0 = p.idx[r];
    auto fetch = [&](int i) -> E {
      return (i >= 0 && i < p.src_rows) ? tab[i * p.width + j] : E(0);
    };
    if (p.iters == 0) {
      out[e] = fetch(i0);
    } else if (kSum) {
      float acc = 0.0f;
      for (int t = 0; t < p.iters; ++t)
        acc += static_cast<float>(fetch(round_index(i0, t, p.mask)));
      out[e] = static_cast<E>(acc);
    } else {
      volatile E* dst = out + e;
      for (int t = 0; t < p.iters; ++t)
        *dst = fetch(round_index(i0, t, p.mask));
    }
  }
}

// ---- GP-C -----------------------------------------------------------------

struct OneHotParams {
  const float* src;  // [K, 8]
  const int32_t* idx;
  float* out;        // [rows, 8]
  int k;
  long long rows;
  int iters, mask;
};

constexpr int kWarpsC = 4;
constexpr uint32_t kBf16One = 0x3F80u;

__device__ __forceinline__ uint32_t onehot_pair(int i, int col) {
  return (i == col ? kBf16One : 0u) | ((i == col + 1 ? kBf16One : 0u) << 16);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kWarpsC * 32) onehot_kernel(
    const OneHotParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sb = reinterpret_cast<uint16_t*>(smem);  // bf16 [K, 8]
  for (int e = threadIdx.x; e < p.k * 8; e += blockDim.x)
    sb[e] = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(p.src + e)));
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // groupID: fragment row (A, C) or column (B)
  const int q = lane & 3;   // thread in group
  const long long tiles = (p.rows + 15) / 16;
  const long long warp0 =
      static_cast<long long>(blockIdx.x) * kWarpsC + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsC;
  for (long long tile = warp0; tile < tiles; tile += stride) {
    const long long r_lo = tile * 16 + g;
    const long long r_hi = r_lo + 8;
    const int i_lo = r_lo < p.rows ? p.idx[r_lo] : -1;
    const int i_hi = r_hi < p.rows ? p.idx[r_hi] : -1;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int rounds = p.iters == 0 ? 1 : p.iters;
    for (int t = 0; t < rounds; ++t) {
      const int lo = p.iters == 0 || i_lo < 0 ? i_lo
                                              : round_index(i_lo, t, p.mask);
      const int hi = p.iters == 0 || i_hi < 0 ? i_hi
                                              : round_index(i_hi, t, p.mask);
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kb = 0; kb < p.k; kb += 16) {
        const int c0 = kb + 2 * q;
        const uint32_t a[4] = {onehot_pair(lo, c0), onehot_pair(hi, c0),
                               onehot_pair(lo, c0 + 8),
                               onehot_pair(hi, c0 + 8)};
        const uint32_t b[2] = {
            static_cast<uint32_t>(sb[c0 * 8 + g]) |
                (static_cast<uint32_t>(sb[(c0 + 1) * 8 + g]) << 16),
            static_cast<uint32_t>(sb[(c0 + 8) * 8 + g]) |
                (static_cast<uint32_t>(sb[(c0 + 9) * 8 + g]) << 16)};
        mma_bf16(d, a, b);
      }
      if (p.iters == 0) {
        for (int j = 0; j < 4; ++j) acc[j] = d[j];
      } else {
        for (int j = 0; j < 4; ++j) acc[j] += d[j];
      }
    }
    if (r_lo < p.rows) {
      p.out[r_lo * 8 + 2 * q] = acc[0];
      p.out[r_lo * 8 + 2 * q + 1] = acc[1];
    }
    if (r_hi < p.rows) {
      p.out[r_hi * 8 + 2 * q] = acc[2];
      p.out[r_hi * 8 + 2 * q + 1] = acc[3];
    }
  }
}

// The redesign.  The block stages bf16(src) (16 B a row) and the count of
// non-finite values of each column in shared memory, its threads' first
// indices fetched meanwhile; then four threads take an output row, two
// channels (one 32-bit word of the bf16 row) each, walking their rows in a
// grid-stride loop (the next row's index fetched ahead) with one 4-byte
// shared load a round: the looped cases' rounds spread over four times the
// threads.
constexpr int kThreadsC = 256;
constexpr int kPartsC = 4;        // threads a row, two channels each
constexpr int kStageLoads = 4;
constexpr uint32_t kBf16ExpMask = 0x7F80u;

// Round t's value of one column: the row's bf16 value widened (+0 for -0),
// or NaN where another row of the column is non-finite; an index outside
// the table reads 0 (NaN in a column with a non-finite value).
__device__ __forceinline__ float onehot_value(uint32_t bits, bool in_table,
                                              int bad) {
  const bool own = in_table && (bits & kBf16ExpMask) == kBf16ExpMask;
  if (bad > (own ? 1 : 0)) return __int_as_float(0x7fffffff);
  return in_table ? __uint_as_float(bits << 16) + 0.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreadsC) onehot_direct_kernel(
    const OneHotParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* sb = reinterpret_cast<uint2*>(smem);    // bf16 [K, 8], 4 to a uint2
  int* bad = reinterpret_cast<int*>(smem + p.k * 16);  // [8]
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the first row's index, fetched while the table stages
  int next = t < p.rows * kPartsC ? p.idx[t / kPartsC] : 0;
  if (threadIdx.x < 8) bad[threadIdx.x] = 0;
  __syncthreads();
  // the table's float4s, kStageLoads a thread in flight at once
  const float4* src4 = reinterpret_cast<const float4*>(p.src);
  const int n4 = p.k * 2;
  for (int e0 = threadIdx.x; e0 < n4; e0 += kStageLoads * blockDim.x) {
    float4 f[kStageLoads];
    #pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n4) f[u] = __ldg(src4 + e);
    }
    #pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= n4) break;
      const float fv[4] = {f[u].x, f[u].y, f[u].z, f[u].w};
      uint32_t h[4];
      for (int j = 0; j < 4; ++j) {
        h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(fv[j]));
        if ((h[j] & kBf16ExpMask) == kBf16ExpMask)
          atomicAdd(bad + 4 * (e & 1) + j, 1);
      }
      sb[e] = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    }
  }
  __syncthreads();
  // the stride is a multiple of kPartsC: a thread keeps its two channels
  const int q = static_cast<int>(t % kPartsC);
  const int bad0 = bad[2 * q], bad1 = bad[2 * q + 1];

  const uint32_t* words = reinterpret_cast<const uint32_t*>(smem);
  for (; t < p.rows * kPartsC; t += stride) {
    const long long r = t / kPartsC;
    const int i0 = next;
    if (t + stride < p.rows * kPartsC) next = p.idx[(t + stride) / kPartsC];
    float acc0 = 0.0f, acc1 = 0.0f;
    const int rounds = p.iters == 0 ? 1 : p.iters;
    for (int u = 0; u < rounds; ++u) {
      const int j = p.iters == 0 || i0 < 0 ? i0 : round_index(i0, u, p.mask);
      const bool in_table = j >= 0 && j < p.k;
      const uint32_t w = in_table ? words[j * kPartsC + q] : 0u;
      const float v0 = onehot_value(w & 0xFFFFu, in_table, bad0);
      const float v1 = onehot_value(w >> 16, in_table, bad1);
      acc0 = p.iters == 0 ? v0 : acc0 + v0;
      acc1 = p.iters == 0 ? v1 : acc1 + v1;
    }
    reinterpret_cast<float2*>(p.out + r * 8)[q] = make_float2(acc0, acc1);
  }
}

unsigned grid_for(long long n, int block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

template <typename E, bool kSum>
void launch_smem(const RowParams& p, int table_bytes, cudaStream_t s) {
  if (table_bytes > 48 * 1024)
    cudaFuncSetAttribute(rows_smem<E, kSum>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         table_bytes);
  long long blocks = (p.out_rows * p.width + kBlock - 1) / kBlock;
  if (blocks > 132 * 8) blocks = 132 * 8;
  rows_smem<E, kSum><<<static_cast<unsigned>(blocks), kBlock, table_bytes,
                       s>>>(p, table_bytes);
}

}  // namespace

// GP-A.  axis 0: out[r,c] = src[idx[r,c], c]; axis 1: out[r,c] =
// src[r, idx[r,c]].  iters > 0 sums the rounds.  Returns cudaGetLastError().
extern "C" int vrt_take_along_axis(const float* src, const int32_t* idx,
                                   float* out, int src_rows, int src_cols,
                                   int out_rows, int out_cols, int axis,
                                   int iters, int mask, void* stream) {
  TakeParams p{src, idx, out, src_rows, src_cols, out_rows, out_cols,
               iters, mask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid =
      grid_for(static_cast<long long>(out_rows) * out_cols, kBlock);
  if (axis == 0) take_kernel<0><<<grid, kBlock, 0, s>>>(p);
  else take_kernel<1><<<grid, kBlock, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// GP-B.  path 0 = ldg, 1 = v16, 2 = smem; elem_bytes 1, 2 or 4; sum 1
// adds f32 rounds (elem_bytes 4), 0 lets the last round win.
extern "C" int vrt_row_gather(const void* src, const int32_t* idx, void* out,
                              long long src_rows, long long out_rows,
                              int width, int elem_bytes, int path,
                              int iters, int mask, int sum, void* stream) {
  RowParams p{src, idx, out, src_rows, out_rows, width, iters, mask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = width * elem_bytes;
  if (path == 1) {
    const int chunks = row_bytes / 16;
    const unsigned grid = grid_for(out_rows * chunks, kBlock);
    if (sum) rows_v16<true><<<grid, kBlock, 0, s>>>(p, chunks);
    else rows_v16<false><<<grid, kBlock, 0, s>>>(p, chunks);
  } else if (path == 2) {
    const int table_bytes = static_cast<int>(src_rows * row_bytes);
    if (table_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
    if (sum) launch_smem<float, true>(p, table_bytes, s);
    else if (elem_bytes == 4) launch_smem<uint32_t, false>(p, table_bytes, s);
    else if (elem_bytes == 2) launch_smem<uint16_t, false>(p, table_bytes, s);
    else launch_smem<uint8_t, false>(p, table_bytes, s);
  } else {
    const unsigned grid = grid_for(out_rows * width, kBlock);
    if (sum) rows_ldg<float, true><<<grid, kBlock, 0, s>>>(p);
    else if (elem_bytes == 4) rows_ldg<uint32_t, false><<<grid, kBlock, 0, s>>>(p);
    else if (elem_bytes == 2) rows_ldg<uint16_t, false><<<grid, kBlock, 0, s>>>(p);
    else rows_ldg<uint8_t, false><<<grid, kBlock, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// GP-C.  out[rows, 8] = onehot(idx, k) @ bf16(src[k, 8]); k % 16 == 0;
// src and out 16-byte aligned.  direct 1 takes the redesign, 0 the first
// design (the tensor cores).
extern "C" int vrt_onehot_gather(const float* src, const int32_t* idx,
                                 float* out, int k, long long rows, int iters,
                                 int mask, int direct, void* stream) {
  OneHotParams p{src, idx, out, k, rows, iters, mask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (direct) {
    const int smem = k * 16 + 8 * 4;
    if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(onehot_direct_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    long long blocks = (rows * kPartsC + kThreadsC - 1) / kThreadsC;
    if (blocks > 132 * 8) blocks = 132 * 8;
    if (blocks < 1) blocks = 1;
    onehot_direct_kernel<<<static_cast<unsigned>(blocks), kThreadsC, smem,
                           s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = k * 8 * 2;
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(onehot_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  long long blocks = ((rows + 15) / 16 + kWarpsC - 1) / kWarpsC;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  onehot_kernel<<<static_cast<unsigned>(blocks), kWarpsC * 32, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
