// Device code shared by the fused NeRF MLP kernels (fused_mlp.cu forward,
// fused_mlp_bwd.cu backward, fused_mlp_int8.cu): the packed-operand layout,
// the frequency encoding of a tile of points, and the fp32 kernels' FFMA
// products and forward layer walk (forward_tile: the fp32 forward and the
// fp32 backward's recompute). The bf16 kernels are wgmma kernels
// (nerf_wgmma.cuh).
//
// Operand layout (packed on the host by cvnerf_torch/ops/fused_mlp.py):
//   wmat (compute dtype): w1 [W,KX], w2..w5 [W,W], w6a [W,W], w6b [W,KX],
//     w7, w8, w9 [W,W], w10a [H,W], w10b [H,KD]; each [out, in] row-major for
//     bf16 (wgmma's K-major B, each block read by TMA, so it starts
//     16-byte aligned with rows of 16-byte multiples)
//     and [in, out] row-major for fp32.
//   wvec (fp32): b1..b9 [W] each, b10 [H], wa [W], w11 [3, H], ba [4], b11 [4]
//     (wa and w11 already rounded to the compute dtype).
// KX = round_up(3 + 6 Lx, 16), KD = round_up(3 + 6 Ld, 16); pad columns and
// rows of the weights are zero. The backward kernel's gradients use the same
// layout, in fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cvnerf {

constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 8;        // shared-memory row padding (elements)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Dims {
  int W, H, KX, KD, Lx, Ld;
};

inline Dims make_dims(int W, int H, int Lx, int Ld) {
  return Dims{W, H, round_up(3 + 6 * Lx, 16), round_up(3 + 6 * Ld, 16), Lx, Ld};
}

struct Offsets {  // element offsets into wmat / wvec
  long w1, w2, w3, w4, w5, w6a, w6b, w7, w8, w9, w10a, w10b, mat_total;
  long b[9], b10, wa, w11, ba, b11, vec_total;
};

__host__ __device__ inline Offsets offsets(const Dims& d) {
  Offsets o;
  long p = 0;
  const long WW = (long)d.W * d.W;
  o.w1 = p; p += (long)d.W * d.KX;
  o.w2 = p; p += WW;
  o.w3 = p; p += WW;
  o.w4 = p; p += WW;
  o.w5 = p; p += WW;
  o.w6a = p; p += WW;
  o.w6b = p; p += (long)d.W * d.KX;
  o.w7 = p; p += WW;
  o.w8 = p; p += WW;
  o.w9 = p; p += WW;
  o.w10a = p; p += (long)d.H * d.W;
  o.w10b = p; p += (long)d.H * d.KD;
  o.mat_total = p;
  long q = 0;
  for (int i = 0; i < 9; ++i) { o.b[i] = q; q += d.W; }
  o.b10 = q; q += d.H;
  o.wa = q; q += d.W;
  o.w11 = q; q += 3L * d.H;
  o.ba = q; q += 4;
  o.b11 = q; q += 4;
  o.vec_total = q;
  return o;
}

// The packed matrices a forward kernel streams by TMA (w1 .. w10b, the
// order of Offsets, the same in the int8 layout), and the fan-in K and
// fan-out N of matrix m.
constexpr int MATS = 12;
__host__ __device__ inline void mat_shape(int m, const Dims& d, int* K, int* N) {
  *K = (m == 0 || m == 6) ? d.KX : (m == 11 ? d.KD : d.W);
  *N = m >= 10 ? d.H : d.W;
}

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) / 128 * 128; }

template <typename T> __device__ inline T from_float(float v);
template <> __device__ inline float from_float<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T and back (the JAX kernels' .astype(compute_dtype)).
template <typename T> __device__ inline float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Encode TILE points into enc_x [TILE, ldx] and enc_d [TILE, ldd] (compute
// dtype), freq_encode's layout, zero pad columns; rows past n are zero.
// Accurate sinf/cosf: 2^k * x is exact in fp32, but the phases reach
// 2^9 * |x| (~3,000 rad at far = 6), where __sinf is wrong.
template <typename T, int TILE>
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts,
                                            const float* __restrict__ dirs, int p0,
                                            int n, const Dims& d, T* enc_x, int ldx,
                                            T* enc_d, int ldd) {
  for (int idx = threadIdx.x; idx < TILE * d.KX; idx += THREADS) {
    const int r = idx / d.KX, c = idx % d.KX;
    const int p = p0 + r;
    float v = 0.f;
    if (p < n && c < 3 + 6 * d.Lx) {
      if (c < 3) {
        v = pts[3L * p + c];
      } else {
        const int k = (c - 3) / 6, j = (c - 3) % 6;
        const float s = pts[3L * p + (j % 3)] * (float)(1 << k);  // exact
        v = j < 3 ? sinf(s) : cosf(s);
      }
    }
    enc_x[r * ldx + c] = from_float<T>(v);
  }
  for (int idx = threadIdx.x; idx < TILE * d.KD; idx += THREADS) {
    const int r = idx / d.KD, c = idx % d.KD;
    const int p = p0 + r;
    float v = 0.f;
    if (p < n && c < 3 + 6 * d.Ld) {
      if (c < 3) {
        v = dirs[3L * p + c];
      } else {
        const int k = (c - 3) / 6, j = (c - 3) % 6;
        const float s = dirs[3L * p + (j % 3)] * (float)(1 << k);
        v = j < 3 ? sinf(s) : cosf(s);
      }
    }
    enc_d[r * ldd + c] = from_float<T>(v);
  }
}

// ------------------------------------------------------------ products
// C[TILE, N] = A[TILE, K] B + A2[TILE, K2] B2, A row-major in shared memory,
// B in global memory with element (k, n) at B[n * ldb + k] (B_COL) or
// B[k * ldb + n]. Every output element goes through epi(row, col, acc),
// which stores it and returns the fp32 value; with COLSUM the returned
// values are also summed per column into colpart[group * N + col]
// (colgroups<TILE>() groups, each summing a fixed set of rows in a fixed
// order, so the sums are deterministic).

// fp32: plain FFMA, never TF32 (the JAX kernels demand Precision.HIGHEST).
// Threads form an RG x CG grid: thread (ty, tx) owns rows ty + RG i (i < R)
// and columns tx + CG j (j < C, up to N <= 256), so that each k step loads
// R activations (shared) and C weights (global, adjacent threads adjacent
// columns) for R x C FFMAs: 4 x 16 for a 64-point tile, 4 x 4 for 16.
template <int TILE> struct FfmaGrid {
  static constexpr int RG = TILE >= 64 ? 16 : 4;
  static constexpr int CG = THREADS / RG;
  static constexpr int R = TILE / RG;
  static constexpr int C = 256 / CG;
};

template <int TILE, bool B_COL, bool COLSUM, class Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, int K,
                                     const float* __restrict__ B, int ldb,
                                     const float* A2, int lda2, int K2,
                                     const float* __restrict__ B2, int ldb2, int N,
                                     float* colpart, const Epi& epi) {
  using G = FfmaGrid<TILE>;
  constexpr int R = G::R, C = G::C;
  const int tx = threadIdx.x % G::CG, ty = threadIdx.x / G::CG;
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + G::RG * i) * lda + k];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = tx + G::CG * j;
      if (c < N) {
        const float w = B_COL ? B[(long)c * ldb + k] : B[(long)k * ldb + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }
  for (int k = 0; k < K2; ++k) {
    float a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A2[(ty + G::RG * i) * lda2 + k];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = tx + G::CG * j;
      if (c < N) {
        const float w = B_COL ? B2[(long)c * ldb2 + k] : B2[(long)k * ldb2 + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = tx + G::CG * j;
    if (c < N) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) s += epi(ty + G::RG * i, c, acc[i][j]);
      if (COLSUM) colpart[ty * N + c] = s;
    }
  }
}

// Row groups of gemm's column partial sums.
template <int TILE> __host__ __device__ constexpr int colgroups() { return FfmaGrid<TILE>::RG; }

// Forward epilogue: bias + optional ReLU in fp32.
struct EpiAct {
  const float* bias;
  bool relu;
  float* out;
  int ldo;
  __device__ __forceinline__ float operator()(int row, int col, float acc) const {
    float v = acc + bias[col];
    if (relu) v = fmaxf(v, 0.f);
    out[row * ldo + col] = v;
    return v;
  }
};

// out[TILE, N] = act(in @ W + in2 @ W2 + bias), W in the packed layout.
template <int TILE>
__device__ __forceinline__ void layer(const float* in, int ldin, int K, const float* W,
                                      const float* in2, int ldin2, int K2, const float* W2,
                                      const float* bias, int N, bool relu, float* out,
                                      int ldout) {
  const EpiAct e{bias, relu, out, ldout};
  gemm<TILE, false, false>(in, ldin, K, W, N, in2, ldin2, K2, W2, N, N, nullptr, e);
}

// The 12-layer walk on one encoded tile: h[0..7] = h1..h8, h[8] = feat
// (l9, no ReLU), h[9] = h10 (l10 on [feat | dir_enc]), each [TILE, ld]
// (fp32). The buffers may alias as long as no layer reads the
// buffer it writes (the forward kernel ping-pongs two). With sig non-null,
// sigma = h8 . wa + ba (fp32) is written to sig[TILE] right after h8.
template <int TILE>
__device__ __forceinline__ void forward_tile(const float* enc_x, int ldx, const float* enc_d,
                                             int ldd, const float* __restrict__ wmat,
                                             const float* __restrict__ wvec, const Dims& d,
                                             const Offsets& o, float* const* h, int ld,
                                             float* sig) {
  const int W = d.W;
  layer<TILE>(enc_x, ldx, d.KX, wmat + o.w1, nullptr, 0, 0, nullptr, wvec + o.b[0], W, true,
              h[0], ld);
  __syncthreads();
  const long wt[4] = {o.w2, o.w3, o.w4, o.w5};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    layer<TILE>(h[l], ld, W, wmat + wt[l], nullptr, 0, 0, nullptr, wvec + o.b[l + 1], W, true,
                h[l + 1], ld);
    __syncthreads();
  }
  // l6 on [xyz_enc | h5]: hidden part + encoding part into one accumulator.
  layer<TILE>(h[4], ld, W, wmat + o.w6a, enc_x, ldx, d.KX, wmat + o.w6b, wvec + o.b[5], W,
              true, h[5], ld);
  __syncthreads();
  layer<TILE>(h[5], ld, W, wmat + o.w7, nullptr, 0, 0, nullptr, wvec + o.b[6], W, true, h[6],
              ld);
  __syncthreads();
  layer<TILE>(h[6], ld, W, wmat + o.w8, nullptr, 0, 0, nullptr, wvec + o.b[7], W, true, h[7],
              ld);
  __syncthreads();
  if (sig != nullptr) {  // sigma = h8 . wa + ba, fp32 (no activation).
    for (int r = threadIdx.x; r < TILE; r += THREADS) {
      float s = 0.f;
      for (int k = 0; k < W; ++k) s = fmaf(h[7][r * ld + k], wvec[o.wa + k], s);
      sig[r] = s + wvec[o.ba];
    }
  }
  // feat = l9(h8), cast without ReLU.
  layer<TILE>(h[7], ld, W, wmat + o.w9, nullptr, 0, 0, nullptr, wvec + o.b[8], W, false, h[8],
              ld);
  __syncthreads();
  // l10 on [feat | dir_enc] (H wide).
  layer<TILE>(h[8], ld, W, wmat + o.w10a, enc_d, ldd, d.KD, wmat + o.w10b, wvec + o.b10, d.H,
              true, h[9], ld);
  __syncthreads();
}

}  // namespace cvnerf
