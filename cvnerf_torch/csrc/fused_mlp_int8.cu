// Fused frequency-encode -> int8 NeRF MLP forward (serving), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// ops/pallas/fused_mlp_int8.py::fused_nerf_apply_int8 (pallas_call at
// fused_mlp_int8.py:268; body _kernel). It computes what apply_nerf_quant
// composed with freq_encode computes (cvnerf_torch/ops/quantize.py):
//   enc_x, enc_d = freq_encode(xyz), freq_encode(dir)         (fp32)
//   q_ex, q_ed   = clip(rint(enc * inv_act), -127, 127)         (int8)
//   h_{i+1}      = clip(rint(acc_i * s_i + b_i), lo, 127)       (int8)
// over the 12-layer graph (l6 on [xyz_enc | h5], l10 on [feat | dir_enc],
// lo = 0 is the ReLU, lo = -127 for the feature layer l9), with every dot an
// exact int8 x int8 -> int32 sum; the heads (sigma off h8, rgb off h10) are
// dequantized to fp32 as acc * s + b. out[n, 4] = (r, g, b, sigma) in fp32.
//
// Bitwise equal to the plain version: the integer sums are exact in any
// order, the int32 -> fp32 casts are exact (|acc| <= 127 * 127 * 319 < 2^24),
// and every fp32 step rounds once as the plain version's does: the multiply
// and the add of acc * s + b are __fmul_rn / __fadd_rn (no contraction into
// an FMA), the rounding is rintf (half to even, as torch.round), the
// encodings are quantized by a multiply with the stored inverse, and the
// encoding's pad columns (inverse 0) quantize to 0.
//
// Bound on this card: operations. 1,186,816 int8 operations per point (the
// float forward's multiply-adds) against 24 B in and 16 B out per point, so
// the tensor cores' 1,979 TOPS (dense int8) bound it long before the 3.35
// TB/s of device memory. Kept simple in this first version:
//   * one block = a tile of TILE = 128 points; the fp32 encodings, the int8
//     encodings and the int8 activations (two ping-pong buffers) stay in
//     shared memory, ~85 KB, two blocks an SM;
//   * products are mma.sync m16n8k32 (s8 x s8 -> s32) written in PTX: each
//     warp owns an 8-column strip of the layer's output for all 128 rows, so
//     one B fragment (4 + 4 weight bytes a lane, read from global memory and
//     kept in the 50 MB L2: 0.58 MB of int8 weights per net) feeds 8 mmas;
//     the A fragments are 32-bit shared-memory loads. (nvcuda::wmma's int8
//     fragments want 32-byte aligned pointers, which 16-byte k steps of an
//     int8 row do not give; the raw mma also leaves each accumulator at a
//     known (row, col) of the thread, so the epilogue needs no scratch.)
//   * the l6 and l10 concatenations are two products accumulated into one
//     int32 accumulator (idot(w6a, h5) + idot(w6b, q_ex));
//   * the epilogue requantizes straight from the accumulator registers and
//     writes int8 pairs into the next activation buffer;
//   * the heads (1 and 3 outputs) are __dp4a dot products, then dequantized;
//   * the encoding is the forward kernel's own (nerf_common.cuh encode_tile,
//     accurate sinf/cosf, freq_encode's layout zero-padded to 16).
// What the TPU kernel did for its matrix unit (the transposed [channels, T]
// layout, the mantissa-split phase matmul, 32-row int8 padding) has no
// counterpart here.
//
// Operand layout (packed by cvnerf_torch/ops/fused_mlp_int8.py::pack_qparams):
//   qmat (int8), each [out, in] row-major: w1 [W,KX], w2..w5 [W,W],
//     w6a [W,W] (hidden part), w6b [W,KX] (encoding part), w7, w8, w9 [W,W],
//     w10a [H,W] (feature part), w10b [H,KD] (dir-encoding part), wa [1,W],
//     w11 [3,H]; pad columns zero.
//   qvec (fp32): inv_x [KX], inv_d [KD] (zero at the pad entries), then
//     s1, b1, ..., s9, b9 [W] each, s10, b10 [H], sa [4], ba [4], s11 [4],
//     b11 [4] (the head vectors zero-padded to 4).

#include "nerf_common.cuh"

namespace {

using namespace cvnerf;

constexpr int TILE = 128;  // points per block
constexpr int MT = TILE / 16;  // 16-row mma tiles per block
constexpr int QPAD = 16;   // int8 shared-memory row padding (bytes)

struct QOffsets {  // element offsets into qmat / qvec
  long w1, w2, w3, w4, w5, w6a, w6b, w7, w8, w9, w10a, w10b, wa, w11, mat_total;
  long inv_x, inv_d, s[9], b[9], s10, b10, sa, ba, s11, b11, vec_total;
};

__host__ __device__ inline QOffsets qoffsets(const Dims& d) {
  QOffsets o;
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
  o.wa = p; p += d.W;
  o.w11 = p; p += 3L * d.H;
  o.mat_total = p;
  long q = 0;
  o.inv_x = q; q += d.KX;
  o.inv_d = q; q += d.KD;
  for (int i = 0; i < 9; ++i) {
    o.s[i] = q; q += d.W;
    o.b[i] = q; q += d.W;
  }
  o.s10 = q; q += d.H;
  o.b10 = q; q += d.H;
  o.sa = q; q += 4;
  o.ba = q; q += 4;
  o.s11 = q; q += 4;
  o.b11 = q; q += 4;
  o.vec_total = q;
  return o;
}

// Dynamic shared-memory plan, in bytes. Region 0 holds the fp32 encodings
// (enc_x [TILE, KX+PAD], enc_d [TILE, KD+PAD]) until they are quantized, then
// the two int8 activation buffers [TILE, W+QPAD]; after it the int8
// encodings [TILE, KX+QPAD] and [TILE, KD+QPAD].
__host__ __device__ inline void smem_plan(const Dims& d, size_t* off_b, size_t* off_fd,
                                          size_t* off_qx, size_t* off_qd, size_t* total) {
  const size_t act = align128((size_t)TILE * (d.W + QPAD));
  const size_t fx = align128((size_t)TILE * (d.KX + PAD) * sizeof(float));
  const size_t fd = align128((size_t)TILE * (d.KD + PAD) * sizeof(float));
  const size_t region = 2 * act > fx + fd ? 2 * act : fx + fd;
  *off_b = act;
  *off_fd = fx;
  size_t p = region;
  *off_qx = p;
  p += align128((size_t)TILE * (d.KX + QPAD));
  *off_qd = p;
  p += align128((size_t)TILE * (d.KD + QPAD));
  *total = p;
}

__device__ __forceinline__ int lds_i32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}
__device__ __forceinline__ int ldg_i32(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

// c += A (16x32, row) * B (32x8, col), int8 -> int32.
__device__ __forceinline__ void mma_k32(int* c, int a0, int a1, int a2, int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// c += A (16x16, row) * B (16x8, col), int8 -> int32 (a K % 32 == 16 tail).
__device__ __forceinline__ void mma_k16(int* c, int a0, int a1, int b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// acc[mt] += A[mt * 16 .. +16, 0:K] @ B[0:K, n0 .. n0 + 8] for every 16-row
// tile of the block. A is int8 row-major in shared memory (lda bytes a
// row), brow points at weight row n0 + g of the [out, K] int8 matrix. K is a
// multiple of 16. Fragment layouts of the PTX ISA (g = lane / 4, t = lane %
// 4): A regs (row g | g + 8, k 4t..4t+3 | +16), B regs (k 4t..4t+3 | +16,
// col g), C (row g | g + 8, col 2t, 2t + 1).
__device__ __forceinline__ void mma_rows(int (&acc)[MT][4], const int8_t* A, int lda, int K,
                                         const int8_t* __restrict__ brow, int g, int t) {
  int k = 0;
  for (; k + 32 <= K; k += 32) {
    const int b0 = ldg_i32(brow + k + 4 * t), b1 = ldg_i32(brow + k + 16 + 4 * t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* a = A + (mt * 16 + g) * lda + k + 4 * t;
      mma_k32(acc[mt], lds_i32(a), lds_i32(a + 8 * lda), lds_i32(a + 16),
              lds_i32(a + 8 * lda + 16), b0, b1);
    }
  }
  if (k < K) {
    const int b0 = ldg_i32(brow + k + 4 * t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* a = A + (mt * 16 + g) * lda + k + 4 * t;
      mma_k16(acc[mt], lds_i32(a), lds_i32(a + 8 * lda), b0);
    }
  }
}

// acc * s + b in fp32, each step rounded once (never an FMA).
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

__device__ __forceinline__ signed char requant(int acc, float s, float b, float lo) {
  const float v = rintf(dequant(acc, s, b));
  return (signed char)(int)fminf(fmaxf(v, lo), 127.f);
}

// out[TILE, N] = clip(rint((A @ B + A2 @ B2) * s + b), lo, 127) as int8, B
// and B2 the [N, K] / [N, K2] int8 weights (K2 = 0: no second part).
__device__ __forceinline__ void qlayer(const int8_t* A, int lda, int K,
                                       const int8_t* __restrict__ B, const int8_t* A2, int lda2,
                                       int K2, const int8_t* __restrict__ B2,
                                       const float* __restrict__ s, const float* __restrict__ b,
                                       int N, float lo, int8_t* out, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  for (int n0 = warp * 8; n0 < N; n0 += WARPS * 8) {
    int acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0;
    mma_rows(acc, A, lda, K, B + (long)(n0 + g) * K, g, t);
    if (K2 > 0) mma_rows(acc, A2, lda2, K2, B2 + (long)(n0 + g) * K2, g, t);
    const int c = n0 + 2 * t;
    const float s0 = __ldg(s + c), s1 = __ldg(s + c + 1);
    const float b0 = __ldg(b + c), b1 = __ldg(b + c + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = mt * 16 + g;
      *reinterpret_cast<char2*>(out + r * ldo + c) =
          make_char2(requant(acc[mt][0], s0, b0, lo), requant(acc[mt][1], s1, b1, lo));
      *reinterpret_cast<char2*>(out + (r + 8) * ldo + c) =
          make_char2(requant(acc[mt][2], s0, b0, lo), requant(acc[mt][3], s1, b1, lo));
    }
  }
}

// Exact int8 dot product of K (a multiple of 4) entries, 4 at a time.
__device__ __forceinline__ int dot_i8(const int8_t* a, const int8_t* __restrict__ w, int K) {
  int acc = 0;
  for (int k = 0; k < K; k += 4) acc = __dp4a(lds_i32(a + k), ldg_i32(w + k), acc);
  return acc;
}

// q[TILE, K] = clip(rint(enc * inv), -127, 127) as int8.
__device__ __forceinline__ void quantize_enc(const float* enc, int ldf, const float* __restrict__ inv,
                                             int K, int8_t* q, int ldq) {
  for (int idx = threadIdx.x; idx < TILE * K; idx += THREADS) {
    const int r = idx / K, c = idx % K;
    const float v = rintf(__fmul_rn(enc[r * ldf + c], __ldg(inv + c)));
    q[r * ldq + c] = (signed char)(int)fminf(fmaxf(v, -127.f), 127.f);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
fused_nerf_int8_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                       const int8_t* __restrict__ qmat, const float* __restrict__ qvec,
                       float* __restrict__ out, int n, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off_b, off_fd, off_qx, off_qd, total;
  smem_plan(d, &off_b, &off_fd, &off_qx, &off_qd, &total);
  int8_t* bufA = reinterpret_cast<int8_t*>(smem);
  int8_t* bufB = reinterpret_cast<int8_t*>(smem + off_b);
  float* enc_x = reinterpret_cast<float*>(smem);
  float* enc_d = reinterpret_cast<float*>(smem + off_fd);
  int8_t* q_ex = reinterpret_cast<int8_t*>(smem + off_qx);
  int8_t* q_ed = reinterpret_cast<int8_t*>(smem + off_qd);
  const int ld = d.W + QPAD, ldx = d.KX + QPAD, ldd = d.KD + QPAD;
  const int W = d.W, H = d.H;
  const QOffsets o = qoffsets(d);
  const int p0 = blockIdx.x * TILE;

  encode_tile<float, TILE>(pts, dirs, p0, n, d, enc_x, d.KX + PAD, enc_d, d.KD + PAD);
  __syncthreads();
  quantize_enc(enc_x, d.KX + PAD, qvec + o.inv_x, d.KX, q_ex, ldx);
  quantize_enc(enc_d, d.KD + PAD, qvec + o.inv_d, d.KD, q_ed, ldd);
  __syncthreads();  // the fp32 encodings' region becomes the activations

  // Activations ping-pong: h1 A, h2 B, h3 A, h4 B, h5 A, h6 B, h7 A, h8 B,
  // feat A, h10 B.
  qlayer(q_ex, ldx, d.KX, qmat + o.w1, nullptr, 0, 0, nullptr, qvec + o.s[0], qvec + o.b[0], W,
         0.f, bufA, ld);
  __syncthreads();
  const long wt[4] = {o.w2, o.w3, o.w4, o.w5};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int8_t* in = l % 2 == 0 ? bufA : bufB;
    int8_t* nxt = l % 2 == 0 ? bufB : bufA;
    qlayer(in, ld, W, qmat + wt[l], nullptr, 0, 0, nullptr, qvec + o.s[l + 1], qvec + o.b[l + 1],
           W, 0.f, nxt, ld);
    __syncthreads();
  }
  // l6 on [xyz_enc | h5]: hidden part + encoding part into one accumulator.
  qlayer(bufA, ld, W, qmat + o.w6a, q_ex, ldx, d.KX, qmat + o.w6b, qvec + o.s[5], qvec + o.b[5],
         W, 0.f, bufB, ld);
  __syncthreads();
  qlayer(bufB, ld, W, qmat + o.w7, nullptr, 0, 0, nullptr, qvec + o.s[6], qvec + o.b[6], W, 0.f,
         bufA, ld);
  __syncthreads();
  qlayer(bufA, ld, W, qmat + o.w8, nullptr, 0, 0, nullptr, qvec + o.s[7], qvec + o.b[7], W, 0.f,
         bufB, ld);
  __syncthreads();
  // sigma = dequant(h8 . wa), fp32 out, written straight to out[:, 3].
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int p = p0 + r;
    if (p < n)
      out[4L * p + 3] = dequant(dot_i8(bufB + r * ld, qmat + o.wa, W), qvec[o.sa], qvec[o.ba]);
  }
  // feat = l9(h8), signed (no ReLU).
  qlayer(bufB, ld, W, qmat + o.w9, nullptr, 0, 0, nullptr, qvec + o.s[8], qvec + o.b[8], W,
         -127.f, bufA, ld);
  __syncthreads();
  // l10 on [feat | dir_enc] (H wide).
  qlayer(bufA, ld, W, qmat + o.w10a, q_ed, ldd, d.KD, qmat + o.w10b, qvec + o.s10, qvec + o.b10,
         H, 0.f, bufB, ld);
  __syncthreads();
  // rgb = dequant(h10 . w11), fp32 out.
  for (int idx = threadIdx.x; idx < TILE * 3; idx += THREADS) {
    const int r = idx / 3, c = idx % 3;
    const int p = p0 + r;
    if (p < n)
      out[4L * p + c] = dequant(dot_i8(bufB + r * ld, qmat + o.w11 + (long)c * H, H),
                                qvec[o.s11 + c], qvec[o.b11 + c]);
  }
}

}  // namespace

extern "C" {

// Element counts of the packed operands, so the host can check its packing
// against the kernel's layout.
long cvnerf_fused_nerf_int8_mat_elems(int W, int H, int Lx, int Ld) {
  return qoffsets(make_dims(W, H, Lx, Ld)).mat_total;
}
long cvnerf_fused_nerf_int8_vec_elems(int W, int H, int Lx, int Ld) {
  return qoffsets(make_dims(W, H, Lx, Ld)).vec_total;
}

// out[n, 4] = fused encode -> int8 MLP of (pts[n, 3], dirs[n, 3]). Launches
// on `stream` and returns cudaGetLastError() of the launch (0 on success);
// does not synchronise.
int cvnerf_fused_nerf_int8_forward(const float* pts, const float* dirs, const void* qmat,
                                   const float* qvec, float* out, int n, int W, int H, int Lx,
                                   int Ld, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  size_t off_b, off_fd, off_qx, off_qd, total;
  smem_plan(d, &off_b, &off_fd, &off_qx, &off_qd, &total);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TILE - 1) / TILE;
  fused_nerf_int8_kernel<<<blocks, THREADS, total, static_cast<cudaStream_t>(stream)>>>(
      pts, dirs, static_cast<const int8_t*>(qmat), qvec, out, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
