// Fused frequency-encode -> NeRF MLP forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas/fused_mlp.py::fused_nerf_apply
// (pallas_call at fused_mlp.py:398; body _kernel -> _encode_inputs +
// _forward_body). It computes the same function: encode xyz (L=10 -> 63) and
// the per-point view direction (L=4 -> 27) in fp32, then the 12-layer graph
//   l1..l5 ReLU; l6 on [xyz_enc | h5] ReLU; l7, l8 ReLU; sigma = h8 . wa + ba;
//   feat = l9(h8) with NO ReLU; l10 on [feat | dir_enc] ReLU; rgb = l11(h10)
// and writes out[n, 4] = (r, g, b, sigma) in fp32.
//
// Bound on this card: operations. The full-width net does 1,186,816 FLOP per
// point against 32 bytes of device-memory traffic (12 B xyz + 12 B dir in,
// 16 B out), ~37,000 FLOP/byte, so the tensor cores (989 TFLOP/s dense bf16)
// or, for the fp32 instantiation, the CUDA cores (67 TFLOP/s FFMA) bound it.
// Design against that bound, kept simple in this first version:
//   * one block = a tile of TILE points; the encodings and every activation
//     stay in shared memory (ping-pong buffers), so nothing but the 32 B per
//     point touches device memory;
//   * weights (1.19 MB per net in bf16, 2.37 MB in fp32) are read straight
//     from global memory and stay resident in the 50 MB L2 across blocks;
//   * bf16: nvcuda::wmma 16x16x16 bf16 products with fp32 accumulators, the
//     bias + ReLU applied in fp32 before the cast to bf16 (the JAX cast points);
//   * fp32: true FFMA on CUDA cores, never TF32 (the JAX kernel demands
//     Precision.HIGHEST);
//   * the l6 skip and the l10 concat are split products accumulated into one
//     accumulator, so no concatenation is materialised;
//   * the encoding uses accurate sinf/cosf: 2^k * x is exact in fp32, but the
//     phases reach 2^9 * |x| (~3,000 rad at far = 6), where __sinf is wrong.
// What the TPU kernel did for its matrix unit (mantissa-split phase matmul,
// the [id|sin|cos] row permutation, the transposed [channels, T] layout, the
// 8-row output padding) has no counterpart here: the encoding keeps
// freq_encode's own layout [x | sin_0 cos_0 | ...], zero-padded to 16.
//
// Operand layout, encoding and the layer walk: nerf_common.cuh (shared with
// the backward kernel, fused_mlp_bwd.cu).

#include "nerf_common.cuh"

namespace {

using namespace cvnerf;

constexpr int TILE = 64;  // points per block

// Dynamic shared-memory plan, in bytes: two activation buffers [TILE, W+PAD],
// enc_x [TILE, KX+PAD], enc_d [TILE, KD+PAD], sigma [TILE], and (bf16 only)
// one 16x16 fp32 scratch per warp.
template <typename T>
__host__ __device__ inline void smem_plan(const Dims& d, size_t* off_b, size_t* off_ex,
                                          size_t* off_ed, size_t* off_sig,
                                          size_t* off_sc, size_t* total) {
  size_t p = 0;
  const size_t act = align128((size_t)TILE * (d.W + PAD) * sizeof(T));
  *off_b = p + act;
  p += 2 * act;
  *off_ex = p;
  p += align128((size_t)TILE * (d.KX + PAD) * sizeof(T));
  *off_ed = p;
  p += align128((size_t)TILE * (d.KD + PAD) * sizeof(T));
  *off_sig = p;
  p += align128(TILE * sizeof(float));
  *off_sc = p;
  if (sizeof(T) == 2) p += WARPS * 256 * sizeof(float);
  *total = p;
}

// fp32 fits one block per SM in shared memory, so its registers need not
// leave room for a second; bf16 fits two.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 1 : 2)
fused_nerf_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                  const T* __restrict__ wmat, const float* __restrict__ wvec,
                  float* __restrict__ out, int n, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off_b, off_ex, off_ed, off_sig, off_sc, total;
  smem_plan<T>(d, &off_b, &off_ex, &off_ed, &off_sig, &off_sc, &total);
  T* bufA = reinterpret_cast<T*>(smem);
  T* bufB = reinterpret_cast<T*>(smem + off_b);
  T* enc_x = reinterpret_cast<T*>(smem + off_ex);
  T* enc_d = reinterpret_cast<T*>(smem + off_ed);
  float* sig = reinterpret_cast<float*>(smem + off_sig);
  float* scratch = reinterpret_cast<float*>(smem + off_sc);
  const int ld = d.W + PAD, ldx = d.KX + PAD, ldd = d.KD + PAD;
  const Offsets o = offsets(d);
  const int p0 = blockIdx.x * TILE;

  encode_tile<T, TILE>(pts, dirs, p0, n, d, enc_x, ldx, enc_d, ldd);
  __syncthreads();
  // Activations ping-pong: h1 A, h2 B, ..., h8 B, feat A, h10 B.
  T* const h[10] = {bufA, bufB, bufA, bufB, bufA, bufB, bufA, bufB, bufA, bufB};
  forward_tile<T, TILE>(enc_x, ldx, enc_d, ldd, wmat, wvec, d, o, h, ld, sig, scratch);
  // rgb = l11(h10), fp32; write (r, g, b, sigma) for the points that exist.
  for (int idx = threadIdx.x; idx < TILE * 3; idx += THREADS) {
    const int r = idx / 3, c = idx % 3;
    const int p = p0 + r;
    if (p >= n) continue;
    float s = 0.f;
    for (int k = 0; k < d.H; ++k)
      s = fmaf(to_float(bufB[r * ld + k]), wvec[o.w11 + (long)c * d.H + k], s);
    out[4L * p + c] = s + wvec[o.b11 + c];
  }
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int p = p0 + r;
    if (p < n) out[4L * p + 3] = sig[r];
  }
}

template <typename T>
int launch(const float* pts, const float* dirs, const void* wmat, const float* wvec,
           float* out, int n, Dims d, cudaStream_t stream) {
  size_t off_b, off_ex, off_ed, off_sig, off_sc, total;
  smem_plan<T>(d, &off_b, &off_ex, &off_ed, &off_sig, &off_sc, &total);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TILE - 1) / TILE;
  fused_nerf_kernel<T><<<blocks, THREADS, total, stream>>>(
      pts, dirs, static_cast<const T*>(wmat), wvec, out, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Element counts of the packed operands, so the host can check its packing
// against the kernel's layout.
long cvnerf_fused_nerf_mat_elems(int W, int H, int Lx, int Ld) {
  return offsets(make_dims(W, H, Lx, Ld)).mat_total;
}
long cvnerf_fused_nerf_vec_elems(int W, int H, int Lx, int Ld) {
  return offsets(make_dims(W, H, Lx, Ld)).vec_total;
}

// out[n, 4] = fused encode -> MLP of (pts[n, 3], dirs[n, 3]). bf16 != 0
// selects the bf16 instantiation. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success); does not synchronise.
int cvnerf_fused_nerf_forward(const float* pts, const float* dirs, const void* wmat,
                              const float* wvec, float* out, int n, int W, int H, int Lx,
                              int Ld, int bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(pts, dirs, wmat, wvec, out, n, d, s);
  return launch<float>(pts, dirs, wmat, wvec, out, n, d, s);
}

}  // extern "C"
