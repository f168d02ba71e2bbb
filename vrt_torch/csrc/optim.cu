// The fit step's Adam update, for Hopper (sm_90a): optax's adam and
// apply_updates over every leaf of a parameter tree in one launch.
//
// It replaces no Pallas kernel: vrt's fit step is one jax.jit
// (vrt/diff/fit.py:159-170, :199-228 for the view step) whose
// optimizer.update (optax's scale_by_adam, then scale(-lr)) and
// optax.apply_updates XLA fuses into one elementwise loop a leaf.  Eager
// PyTorch runs the same lines as fourteen passes a leaf
// (vrt_torch/kernels/optim.py adam_step_reference: the plain version).
//
// Per element, in optax's order and with each operation rounded once, as
// the eager ops round them (no contraction into an FMA):
//
//   mu' = (1 - b1) g + b1 mu
//   nu' = (1 - b2) (g g) + b2 nu
//   u   = (-lr) ((mu' / c1) / (sqrt(nu' / c2) + eps))
//   out = p + u             (or u itself: the update variant)
//
// c1 = 1 - b1^count and c2 = 1 - b2^count are 0-d f32 tensors on the card,
// read by pointer, so the caller never waits on the card; (1 - b1),
// (1 - b2) and -lr are formed in double and rounded to f32 by the caller, as
// the eager ops receive them.  The outputs are new tensors (the step stays
// functional, as optax's).
//
// What bounds it: bytes.  p, g, mu, nu read and out, mu', nu' written: 28 B
// an element (24 without p); config4's 67.9 M elements move 1.90 GB, 0.567
// ms at 3.35 TB/s.  The design: a block of 256 threads takes 1,024
// elements of one leaf (a leaf's blocks are contiguous in the grid, so a
// block's leaf is uniform), a thread 4 of them with 16-byte loads and
// stores where the leaf's seven pointers lie on 16-byte boundaries, else
// (and in a leaf's last partial word: 257^3 is odd) one element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kMaxLeaves = 16;

struct Leaf {
  const float* p;   // null in the update variant
  const float* g;
  const float* mu;
  const float* nu;
  float* out;       // p + u, or u
  float* mu_out;
  float* nu_out;
  long long n;
  unsigned int first_block;  // the leaf's first block in the grid
  int vec;                   // all seven pointers on 16-byte boundaries
};

struct AdamParams {
  Leaf leaf[kMaxLeaves];
  int leaves;
  const float* c1;
  const float* c2;
  float omb1, b1, omb2, b2, neg_lr, eps;
};

struct Moments {
  float out, mu, nu;
};

template <bool kApply>
__device__ __forceinline__ Moments adam_one(float p, float g, float mu,
                                            float nu, const AdamParams& a,
                                            float c1, float c2) {
  Moments m;
  m.mu = __fadd_rn(__fmul_rn(a.omb1, g), __fmul_rn(a.b1, mu));
  m.nu = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(g, g)), __fmul_rn(a.b2, nu));
  const float u = __fmul_rn(
      a.neg_lr, __fdiv_rn(__fdiv_rn(m.mu, c1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(m.nu, c2)), a.eps)));
  m.out = kApply ? __fadd_rn(p, u) : u;
  return m;
}

template <bool kApply>
__global__ void __launch_bounds__(kThreads) adam_kernel(
    const __grid_constant__ AdamParams a) {
  // the block's leaf: the last whose first block is at or below this one,
  // read in place from the parameters (__grid_constant__: no copy)
  int l = 0;
#pragma unroll
  for (int i = 1; i < kMaxLeaves; ++i)
    if (i < a.leaves && blockIdx.x >= a.leaf[i].first_block) l = i;
  const Leaf& L = a.leaf[l];
  const long long e =
      (static_cast<long long>(blockIdx.x - L.first_block) * kThreads +
       threadIdx.x) * kPerThread;
  if (e >= L.n) return;
  const float c1 = __ldg(a.c1), c2 = __ldg(a.c2);
  if (L.vec && e + kPerThread <= L.n) {
    const long long w = e / kPerThread;
    const float4 g = __ldg(reinterpret_cast<const float4*>(L.g) + w);
    const float4 mu = __ldg(reinterpret_cast<const float4*>(L.mu) + w);
    const float4 nu = __ldg(reinterpret_cast<const float4*>(L.nu) + w);
    const float4 p = kApply ? __ldg(reinterpret_cast<const float4*>(L.p) + w)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const Moments m0 = adam_one<kApply>(p.x, g.x, mu.x, nu.x, a, c1, c2);
    const Moments m1 = adam_one<kApply>(p.y, g.y, mu.y, nu.y, a, c1, c2);
    const Moments m2 = adam_one<kApply>(p.z, g.z, mu.z, nu.z, a, c1, c2);
    const Moments m3 = adam_one<kApply>(p.w, g.w, mu.w, nu.w, a, c1, c2);
    reinterpret_cast<float4*>(L.out)[w] =
        make_float4(m0.out, m1.out, m2.out, m3.out);
    reinterpret_cast<float4*>(L.mu_out)[w] =
        make_float4(m0.mu, m1.mu, m2.mu, m3.mu);
    reinterpret_cast<float4*>(L.nu_out)[w] =
        make_float4(m0.nu, m1.nu, m2.nu, m3.nu);
    return;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = e + k;
    if (i >= L.n) break;
    const Moments m = adam_one<kApply>(kApply ? __ldg(L.p + i) : 0.f,
                                       __ldg(L.g + i), __ldg(L.mu + i),
                                       __ldg(L.nu + i), a, c1, c2);
    L.out[i] = m.out;
    L.mu_out[i] = m.mu;
    L.nu_out[i] = m.nu;
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// The Adam update of `leaves` f32 leaves: ptrs holds seven pointers a leaf
// (p, g, mu, nu, out, mu_out, nu_out; p null where apply = 0, and out then
// receives the update u in place of p + u), sizes the elements of each.
// c1 and c2 are 0-d f32 tensors on the card (1 - b1^count, 1 - b2^count);
// omb1 = (1 - b1), omb2 = (1 - b2), neg_lr = -lr, each rounded to f32.  One
// launch for every 16 leaves that hold an element.  Returns the launches
// made, or minus the cudaError where one failed.
extern "C" int vrt_adam_step(int leaves, void* const* ptrs,
                             const long long* sizes, const float* c1,
                             const float* c2, float omb1, float b1,
                             float omb2, float b2, float neg_lr, float eps,
                             int apply, void* stream) {
  if (leaves < 0 || c1 == nullptr || c2 == nullptr)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_block = static_cast<long long>(kThreads) * kPerThread;
  int launches = 0;
  AdamParams a{};
  a.c1 = c1;
  a.c2 = c2;
  a.omb1 = omb1;
  a.b1 = b1;
  a.omb2 = omb2;
  a.b2 = b2;
  a.neg_lr = neg_lr;
  a.eps = eps;
  long long blocks = 0;
  for (int i = 0; i <= leaves; ++i) {
    const bool flush = i == leaves || a.leaves == kMaxLeaves;
    if (flush && a.leaves > 0) {
      if (blocks > 0x7fffffffll)
        return -static_cast<int>(cudaErrorInvalidValue);
      const dim3 grid(static_cast<unsigned>(blocks));
      if (apply) adam_kernel<true><<<grid, kThreads, 0, st>>>(a);
      else adam_kernel<false><<<grid, kThreads, 0, st>>>(a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return -static_cast<int>(err);
      ++launches;
      a.leaves = 0;
      blocks = 0;
    }
    if (i == leaves) break;
    if (sizes[i] < 0) return -static_cast<int>(cudaErrorInvalidValue);
    if (sizes[i] == 0) continue;
    void* const* q = ptrs + 7 * i;
    Leaf& L = a.leaf[a.leaves++];
    L.p = static_cast<const float*>(q[0]);
    L.g = static_cast<const float*>(q[1]);
    L.mu = static_cast<const float*>(q[2]);
    L.nu = static_cast<const float*>(q[3]);
    L.out = static_cast<float*>(q[4]);
    L.mu_out = static_cast<float*>(q[5]);
    L.nu_out = static_cast<float*>(q[6]);
    if ((apply && L.p == nullptr) || L.g == nullptr || L.mu == nullptr ||
        L.nu == nullptr || L.out == nullptr || L.mu_out == nullptr ||
        L.nu_out == nullptr)
      return -static_cast<int>(cudaErrorInvalidValue);
    L.n = sizes[i];
    L.first_block = static_cast<unsigned int>(blocks);
    L.vec = (!apply || aligned(L.p)) && aligned(L.g) && aligned(L.mu) &&
            aligned(L.nu) && aligned(L.out) && aligned(L.mu_out) &&
            aligned(L.nu_out);
    blocks += (L.n + per_block - 1) / per_block;
  }
  return launches;
}
