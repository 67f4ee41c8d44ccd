// Instant-NGP's multiresolution hash encoding on the card (sm_90a): the
// forward gather and trilinear blend, and its backward's scatter-add into an
// fp32 gradient table.
//
// It replaces no TPU kernel: the JAX package has no hash-grid field. It was
// added for the port's Instant-NGP field (models/ngp_field.py), whose work a
// sample is 16 levels x 8 corners of table lookups, beside 9,408
// multiply-adds of two small MLPs.
//
// What bounds it on this card: the forward moves bytes (8 B a gathered
// entry, 12 B of position in and 128 B of features out a sample; the whole
// table, 48.8 MB at the published widths, is about the size of the 50 MB
// L2); the backward's 128 float2 atomic adds a sample into the gradient
// table bound it by the L2's atomic throughput. This first design is correct
// and simple: one thread a (sample, level), levels on the grid's y axis so a
// block's threads share a level's table, the level's parameters in the
// kernel's parameters.
//
// The arithmetic is ops/hash_encode.py's plain version op for op: each
// product and sum rounded once (__fmul_rn, __fadd_rn, __fsub_rn, which nvcc
// never contracts into an FMA), the corners in the same order, so the
// forward is bitwise the plain version on the same card. The backward's
// atomics sum in no fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;  // ops/hash_encode.py MAX_LEVELS
constexpr int kThreads = 256;
constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 805459861u;

struct Level {
  const float2* table;  // forward: the level's entries; backward: its grads
  unsigned entries;
  unsigned res;
  float scale;
  int dense;
};

struct Grid {
  Level lv[kMaxLevels];
  int levels;
};

// A corner's table index: dense (x0 + x1 res + x2 res^2) or hashed, modulo
// the level's entries.
__device__ __forceinline__ unsigned corner_index(const Level& L, unsigned x0,
                                                 unsigned x1, unsigned x2) {
  const unsigned idx = L.dense ? x0 + x1 * L.res + x2 * (L.res * L.res)
                               : x0 ^ (x1 * kPrime1) ^ (x2 * kPrime2);
  return idx % L.entries;
}

// The cell and the fractions of a position on a level.
__device__ __forceinline__ void locate(const Level& L, const float* __restrict__ unit,
                                       long long i, unsigned cell[3],
                                       float frac[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x = fminf(fmaxf(__ldg(unit + 3 * i + d), 0.f), 1.f);
    const float pos = __fadd_rn(__fmul_rn(x, L.scale), 0.5f);
    const float f = floorf(pos);
    cell[d] = (unsigned)f;
    frac[d] = __fsub_rn(pos, f);
  }
}

// Corner c's index and weight: upper in dimension d where bit d of c is
// set, the weight multiplied in order d = 0, 1, 2.
__device__ __forceinline__ unsigned corner(const Level& L, const unsigned cell[3],
                                           const float frac[3], int c,
                                           float& w) {
  unsigned q[3];
  w = 1.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if ((c >> d) & 1) {
      w = __fmul_rn(w, frac[d]);
      q[d] = cell[d] + 1;
    } else {
      w = __fmul_rn(w, __fsub_rn(1.f, frac[d]));
      q[d] = cell[d];
    }
  }
  return corner_index(L, q[0], q[1], q[2]);
}

__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd(const float* __restrict__ unit, long long n,
                    const __grid_constant__ Grid g, float* __restrict__ out32,
                    __nv_bfloat16* __restrict__ out16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const Level& L = g.lv[l];
  unsigned cell[3];
  float frac[3];
  locate(L, unit, i, cell, frac);
  float ax = 0.f, ay = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float w;
    const unsigned idx = corner(L, cell, frac, c, w);
    const float2 v = __ldg(L.table + idx);
    ax = __fadd_rn(ax, __fmul_rn(w, v.x));
    ay = __fadd_rn(ay, __fmul_rn(w, v.y));
  }
  const long long o = i * (2 * g.levels) + 2 * l;
  if (out16 != nullptr) {
    out16[o] = __float2bfloat16_rn(ax);
    out16[o + 1] = __float2bfloat16_rn(ay);
  } else {
    *reinterpret_cast<float2*>(out32 + o) = make_float2(ax, ay);
  }
}

__device__ __forceinline__ void add2(float2* p, float x, float y) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(p, make_float2(x, y));  // one vector atomic (sm_90)
#else
  atomicAdd(&p->x, x);
  atomicAdd(&p->y, y);
#endif
}

__global__ void __launch_bounds__(kThreads)
    hash_encode_bwd(const float* __restrict__ unit, long long n,
                    const __grid_constant__ Grid g,
                    const float* __restrict__ grad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const Level& L = g.lv[l];
  unsigned cell[3];
  float frac[3];
  locate(L, unit, i, cell, frac);
  const float2 d = __ldg(reinterpret_cast<const float2*>(
      grad + i * (2 * g.levels) + 2 * l));
  float2* table = const_cast<float2*>(L.table);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float w;
    const unsigned idx = corner(L, cell, frac, c, w);
    add2(table + idx, __fmul_rn(w, d.x), __fmul_rn(w, d.y));
  }
}

int make_grid(Grid& g, const long long* tables, const int* entries,
              const int* res, const float* scale, const int* dense,
              int levels) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  g.levels = levels;
  for (int l = 0; l < levels; ++l) {
    if (entries[l] < 1) return (int)cudaErrorInvalidValue;
    g.lv[l].table = (const float2*)tables[l];
    g.lv[l].entries = (unsigned)entries[l];
    g.lv[l].res = (unsigned)res[l];
    g.lv[l].scale = scale[l];
    g.lv[l].dense = dense[l];
  }
  return 0;
}

dim3 grid_of(long long n, int levels) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)levels);
}

}  // namespace

extern "C" {

// Forward over n positions (unit, [n, 3] float32): tables holds a device
// pointer a level ([entries, 2] float32), entries/res/scale/dense the
// levels' geometry; writes [n, 2 levels] features to out, bfloat16 where
// out_bf16 is nonzero, else float32. Returns cudaGetLastError() of the
// launch.
int cvnerf_hash_encode_fwd(const void* unit, void* out, long long n,
                           const long long* tables, const int* entries,
                           const int* res, const float* scale,
                           const int* dense, int levels, int out_bf16,
                           void* stream) {
  Grid g;
  const int err = make_grid(g, tables, entries, res, scale, dense, levels);
  if (err != 0 || n < 1) return err != 0 ? err : (int)cudaErrorInvalidValue;
  hash_encode_fwd<<<grid_of(n, levels), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)unit, n, g, out_bf16 ? nullptr : (float*)out,
      out_bf16 ? (__nv_bfloat16*)out : nullptr);
  return (int)cudaGetLastError();
}

// Backward over n positions: grad ([n, 2 levels] float32) scattered with
// atomic adds into the levels' gradient tables (tables: a device pointer a
// level, zeroed by the caller on the same stream). The unused int keeps the
// forward's signature.
int cvnerf_hash_encode_bwd(const void* unit, const void* grad, long long n,
                           const long long* tables, const int* entries,
                           const int* res, const float* scale,
                           const int* dense, int levels, int unused,
                           void* stream) {
  (void)unused;
  Grid g;
  const int err = make_grid(g, tables, entries, res, scale, dense, levels);
  if (err != 0 || n < 1) return err != 0 ? err : (int)cudaErrorInvalidValue;
  hash_encode_bwd<<<grid_of(n, levels), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)unit, n, g, (const float*)grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
