// Device code shared by the fused NeRF MLP kernels (fused_mlp.cu forward,
// fused_mlp_bwd.cu backward, fused_mlp_int8.cu): the packed-operand layout
// and the compute-dtype casts. The bf16 and int8 kernels are wgmma kernels
// (nerf_wgmma.cuh), the fp32 ones FFMA kernels (nerf_ffma.cuh).
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

// The packed matrices a forward kernel streams (by TMA, in fp32 by bulk
// copies; w1 .. w10b, the order of Offsets, the same in the int8 layout),
// and the fan-in K and fan-out N of matrix m.
constexpr int MATS = 12;
__host__ __device__ inline void mat_shape(int m, const Dims& d, int* K, int* N) {
  *K = (m == 0 || m == 6) ? d.KX : (m == 11 ? d.KD : d.W);
  *N = m >= 10 ? d.H : d.W;
}

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

}  // namespace cvnerf
