// Adam over every leaf of a train state in one launch, on the card (sm_90a).
//
// It replaces no TPU kernel: the JAX package's optimizer is optax's adam in
// plain jnp (its train/state.py), which XLA fuses into the train step's one
// program. In PyTorch the same update, written per leaf (train/state.py's
// Adam.update before this kernel, now ops/adam.py::adam_plain), is 14
// elementwise ops a leaf: 672 launches a step over the two nets' 48 leaves,
// each a node of a block's CUDA graph, a third of them on PyTorch's
// broadcasting path because the bias corrections and the step size are 0-d
// device tensors.
//
// What bounds it on this card: bytes. A value reads p, g, m, v and writes p,
// m, v, 28 bytes for ~15 flops; at the lego nets' 1,191,688 values that is
// 33.4 MB, 0.010 ms at 3.35 TB/s. So the kernel is one pass over the values
// of all leaves: a table of leaves (7 pointers and the value counts of each)
// travels by value in the kernel's parameters, each thread walks work units
// (four values through 16-byte loads where the leaf's pointers allow, else
// one value) over a grid sized from the SM count, and finds its leaf by a
// binary search of the table's unit offsets.
//
// Two per-leaf rules, for the Instant-NGP field (models/ngp_field.py): an L2
// factor (g += l2 p, the paper's L2 on the MLP weights) and skip_zero (a
// value whose gradient is exactly 0 keeps p, m and v: table entries no
// sample touched). A leaf with neither computes what it did before.
//
// Bitwise the plain version: each op of adam_plain rounds once in float32 and
// PyTorch contracts nothing, so the kernel writes each op as its correctly
// rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never fuses into an FMA, in the plain version's order.

#include <cuda_runtime.h>

namespace {

// Leaves a table holds: the most whose table fits the 4 KB of parameters.
constexpr int kLeaves = 56;

struct Table {
  const float* scalars;  // [3] on the card: -lr, 1 - b1^t, 1 - b2^t
  unsigned long long skip_zero;  // bit i: leaf i skips exactly-zero grads
  float c1, b1, c2, b2, eps;  // 1 - b1, b1, 1 - b2, b2, eps as float32
  int leaves;
  long long start[kLeaves + 1];  // first unit of each leaf; start[leaves]: all
  int nvec[kLeaves];             // units of four values (the rest: of one)
  float l2[kLeaves];             // each leaf's L2 factor (0: none)
  const float* p[kLeaves];
  const float* g[kLeaves];
  const float* m[kLeaves];
  const float* v[kLeaves];
  float* p_out[kLeaves];
  float* m_out[kLeaves];
  float* v_out[kLeaves];
};
static_assert(sizeof(Table) <= 4096, "a table must fit the kernel parameters");

struct Scalars {
  float step, bc1, bc2, c1, b1, c2, b2, eps;
};

// One value: adam_plain's ops in its order, each rounded once; with an L2
// factor the gradient takes l2 p first, and under skip_zero a zero gradient
// leaves the value as it was.
__device__ __forceinline__ void adam_value(const Scalars& s, float p, float g,
                                           float m, float v, float& p_out,
                                           float& m_out, float& v_out,
                                           float l2, bool skip) {
  if (l2 != 0.f) g = __fadd_rn(g, __fmul_rn(l2, p));
  if (skip && g == 0.f) {
    p_out = p;
    m_out = m;
    v_out = v;
    return;
  }
  m_out = __fadd_rn(__fmul_rn(s.c1, g), __fmul_rn(s.b1, m));
  v_out = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v_out, s.bc2)), s.eps);
  p_out = __fadd_rn(
      p, __fmul_rn(s.step, __fdiv_rn(__fdiv_rn(m_out, s.bc1), denom)));
}

__global__ void __launch_bounds__(256)
    fused_adam_kernel(const __grid_constant__ Table t) {
  const Scalars s{__ldg(t.scalars), __ldg(t.scalars + 1),
                  __ldg(t.scalars + 2), t.c1, t.b1, t.c2, t.b2, t.eps};
  const long long total = t.start[t.leaves];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < total; u += stride) {
    int lo = 0, hi = t.leaves - 1;  // the last leaf starting at or before u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.start[mid] <= u) lo = mid; else hi = mid - 1;
    }
    const long long k = u - t.start[lo], nvec = t.nvec[lo];
    const float l2 = t.l2[lo];
    const bool skip = (t.skip_zero >> lo) & 1ull;
    if (k < nvec) {
      const float4 p = __ldg(reinterpret_cast<const float4*>(t.p[lo]) + k);
      const float4 g = __ldg(reinterpret_cast<const float4*>(t.g[lo]) + k);
      const float4 m = __ldg(reinterpret_cast<const float4*>(t.m[lo]) + k);
      const float4 v = __ldg(reinterpret_cast<const float4*>(t.v[lo]) + k);
      float4 po, mo, vo;
      adam_value(s, p.x, g.x, m.x, v.x, po.x, mo.x, vo.x, l2,
                 skip);
      adam_value(s, p.y, g.y, m.y, v.y, po.y, mo.y, vo.y, l2,
                 skip);
      adam_value(s, p.z, g.z, m.z, v.z, po.z, mo.z, vo.z, l2,
                 skip);
      adam_value(s, p.w, g.w, m.w, v.w, po.w, mo.w, vo.w, l2,
                 skip);
      reinterpret_cast<float4*>(t.p_out[lo])[k] = po;
      reinterpret_cast<float4*>(t.m_out[lo])[k] = mo;
      reinterpret_cast<float4*>(t.v_out[lo])[k] = vo;
    } else {
      const long long i = 4 * nvec + (k - nvec);
      adam_value(s, __ldg(t.p[lo] + i), __ldg(t.g[lo] + i),
                 __ldg(t.m[lo] + i), __ldg(t.v[lo] + i), t.p_out[lo][i],
                 t.m_out[lo][i], t.v_out[lo][i], l2, skip);
    }
  }
}

}  // namespace

extern "C" {

// The leaves one launch takes (ops/adam.py's TABLE_LEAVES).
int cvnerf_fused_adam_table_leaves() { return kLeaves; }

// One launch over `leaves` leaves: ptrs holds 7 device pointers a leaf (p, g,
// m, v, p_out, m_out, v_out), nvec its units of four values and nsingle its
// units of one, skip_zero its flag and l2 its L2 factor; scalars points to the step's [-lr, bc1, bc2] on the card.
// Launches `grid` blocks of 256 threads on `stream`; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a table
// that does not fit.
int cvnerf_fused_adam(const long long* ptrs, const long long* nvec,
                      const long long* nsingle, const int* skip_zero,
                      const float* l2, int leaves, const void* scalars,
                      float c1, float b1, float c2, float b2, float eps,
                      int grid, void* stream) {
  if (leaves < 1 || leaves > kLeaves || grid < 1) return cudaErrorInvalidValue;
  Table t;
  t.scalars = (const float*)scalars;
  t.skip_zero = 0;
  t.c1 = c1; t.b1 = b1; t.c2 = c2; t.b2 = b2; t.eps = eps;
  t.leaves = leaves;
  t.start[0] = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long* q = ptrs + 7 * i;
    t.p[i] = (const float*)q[0];
    t.g[i] = (const float*)q[1];
    t.m[i] = (const float*)q[2];
    t.v[i] = (const float*)q[3];
    t.p_out[i] = (float*)q[4];
    t.m_out[i] = (float*)q[5];
    t.v_out[i] = (float*)q[6];
    if (nvec[i] > 0x7fffffffLL) return cudaErrorInvalidValue;
    t.nvec[i] = (int)nvec[i];
    t.l2[i] = l2[i];
    if (skip_zero[i]) t.skip_zero |= 1ull << i;
    t.start[i + 1] = t.start[i] + nvec[i] + nsingle[i];
  }
  fused_adam_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

}  // extern "C"
