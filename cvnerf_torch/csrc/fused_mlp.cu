// Fused frequency-encode -> NeRF MLP forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas/fused_mlp.py::fused_nerf_apply
// (pallas_call at fused_mlp.py:398; body _kernel -> _encode_inputs +
// _forward_body). It computes the same function: encode xyz (L=10 -> 63) and
// the per-point view direction (L=4 -> 27) in fp32, then the 12-layer graph
//   l1..l5 ReLU; l6 on [xyz_enc | h5] ReLU; l7, l8 ReLU; sigma = h8 . wa + ba;
//   feat = l9(h8) with NO ReLU; l10 on [feat | dir_enc] ReLU; rgb = l11(h10)
// and writes out[n, 4] = (r, g, b, sigma) in fp32, with the JAX cast points:
// encodings in fp32 rounded to bf16, bias + ReLU in fp32 and a cast to bf16
// between layers, sigma and rgb in fp32 from the rounded h8 and h10.
//
// What bounds it on this card: operations. The full-width net does 1,186,816
// FLOP per point against 24 B in and 16 B out of device memory, so the
// tensor cores (989 TFLOP/s dense bf16) bound it: 1.887 ms for a fine chunk
// of 1,572,864 points. The cost that stands between a kernel and that bound
// is the weights: all 1.19 MB of them (bf16) pass through every tile of
// points, so a tile of M points reads each weight byte once per M FLOP. At
// M = 64 with each warp fetching its own fragments from L2 (the first
// version: nvcuda::wmma 16x16x16, weights re-read per 16x16 output tile,
// ~74 KB of L2 reads a point) the kernel sat at ~4.5% of the bound, limited
// by the latency of those unstaged loads.
//
// bf16 design (fused_nerf_wgmma):
//   * one persistent block per SM walks tiles of 128 points: one producer
//     warpgroup and two consumer warpgroups of 64 points each;
//   * the producer's one thread streams every layer's weights, tile after
//     tile, in the fixed order matrix -> 64-column k chunk, by TMA (one
//     tensor map per packed matrix, box [fan-out, 64], 128-byte swizzle)
//     into a ring of 2-8 shared-memory stages with full/empty mbarriers;
//     both consumer warpgroups read each staged chunk, so each weight byte
//     leaves L2 once per 128 points (1.19 MB a tile, 9.3 KB a point, 8x
//     less than the first version) and the loads run ahead of the products;
//   * products are wgmma.mma_async m64n64k16 bf16 -> fp32 across the
//     fan-out (staged padded to a multiple of 64 with zero rows by TMA;
//     one m64n256k16 a k16 step measured no faster), the weights the
//     K-major B operand straight from the staged chunk, the accumulator
//     of a whole layer (up to 64 x 256 fp32, 128 registers a thread) in
//     registers; the lego widths are compile-time constants, other widths
//     run-time values, behind whose tests ptxas serialises the wgmmas;
//   * activations stay in registers: a layer's accumulator fragment, after
//     bias + ReLU in fp32 and the cast to bf16, is the register A fragment
//     of the next layer's wgmma (the FlashAttention-3 trick), so h1..h10
//     never touch shared memory; setmaxnreg gives the consumers 240
//     registers and the producer 24;
//   * the encodings of a warpgroup's 64 points (accurate sinf/cosf: 2^k x
//     is exact in fp32, but the phases reach 2^9 |x|, where __sinf is
//     wrong) go to a small padded shared-memory buffer once per tile and
//     are read as A fragments by l1, l6 and l10; the l6 skip and the l10
//     concat are split products into one accumulator. The raw inputs are
//     staged first by coalesced loads: read value by value (as
//     encode_tile does for the other kernels) their latency, unhidden by
//     2 warpgroups an SM, took half the kernel's time;
//   * sigma and rgb are per-thread partial dots over the thread's columns
//     of the rounded h8 / h10, summed over the 4 threads of a row with
//     __shfl_xor_sync; rows past n compute on the encoded origin and are
//     never written; no atomics, a fixed tile -> block map: two launches on the
//     same inputs are bitwise equal.
// fp32 (no main path runs it): the first version's FFMA walk, never TF32
// (the JAX kernel demands Precision.HIGHEST), through nerf_common.cuh's
// forward_tile with activations ping-ponging in shared memory.
// What the TPU kernel did for its matrix unit (mantissa-split phase matmul,
// the [id|sin|cos] row permutation, the transposed [channels, T] layout, the
// 8-row output padding) has no counterpart here: the encoding keeps
// freq_encode's own layout [x | sin_0 cos_0 | ...], zero-padded to 16.
//
// Operand layout and encoding: nerf_common.cuh (shared with the backward and
// int8 kernels). The warp-specialised block, its register budget and the
// staged encoding: nerf_wgmma.cuh (shared with the int8 kernel), and in its
// namespace bf16wg the shared-memory plan, product, load_frags, epilogue and
// encode_wg (shared with the backward's pass 1, fused_mlp_bwd.cu). wgmma,
// TMA, mbarrier helpers and the ring of weight stages: hopper.cuh.

#include "nerf_wgmma.cuh"

namespace {

using namespace cvnerf;
using namespace cvnerf::bf16wg;
using namespace hopper;

// The consumer warpgroups' walk over their tiles. FW, FH, FKX, FKD fix the
// widths at compile time (0: read them from d), so that every wgmma of a
// product is issued unconditionally.
template <int FW, int FH, int FKX, int FKD>
__device__ __forceinline__ void consumer(const float* __restrict__ pts,
                                         const float* __restrict__ dirs,
                                         const float* __restrict__ wvec, float* __restrict__ out,
                                         int n, const Dims& d, int tiles, const Bf16Plan& pl,
                                         unsigned char* smem, Ring& ring) {
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int row = (tid / 32) * 16 + lane / 4;  // this thread's rows: row, row + 8
  unsigned char* mine = smem + pl.enc_at + wg * pl.wg_bytes;
  __nv_bfloat16* ex = reinterpret_cast<__nv_bfloat16*>(mine);
  __nv_bfloat16* ed = ex + WG_ROWS * pl.ldx;
  float* raw = reinterpret_cast<float*>(ed + WG_ROWS * pl.ldd);
  const Offsets o = offsets(d);
  const int W = FW ? FW : d.W, H = FH ? FH : d.H;
  const int KX = FKX ? FKX : d.KX, KD = FKD ? FKD : d.KD;
  float acc[128];
  uint32_t a[16][4];

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * WS_TILE + wg * WG_ROWS;
    named_sync(1 + wg, WG);  // the last tile's reads of ex / ed / raw are done
    encode_wg(pts, dirs, p0, n, d, KX, KD, ex, pl.ldx, ed, pl.ldd, raw, 1 + wg, tid);
    named_sync(1 + wg, WG);
    // Define acc and a afresh (the wgmmas read both as operands), so that
    // the last tile's values are dead while the encoding runs.
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0u;

    // l1: enc_x
    load_frags(a, ex, pl.ldx, KX);
    product(acc, a, KX, W, true, ring);
    epilogue(acc, a, wvec + o.b[0], W, true);
    // l2..l5 (bias l at wvec + l W)
#pragma unroll 1
    for (int l = 1; l < 5; ++l) {
      product(acc, a, W, W, true, ring);
      epilogue(acc, a, wvec + l * W, W, true);
    }
    // l6 on [xyz_enc | h5]: h5 with w6a, then enc_x with w6b, one accumulator.
    product(acc, a, W, W, true, ring);
    load_frags(a, ex, pl.ldx, KX);
    product(acc, a, KX, W, false, ring);
    epilogue(acc, a, wvec + o.b[5], W, true);
    // l7, l8
#pragma unroll 1
    for (int l = 6; l < 8; ++l) {
      product(acc, a, W, W, true, ring);
      epilogue(acc, a, wvec + l * W, W, true);
    }
    // sigma = h8 . wa + ba, fp32, from the rounded h8.
    float s0 = 0.f, s8 = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (c * 16 < W) {
        const float2 w0 = __ldg(reinterpret_cast<const float2*>(wvec + o.wa + c * 16 + 2 * q));
        const float2 w1 =
            __ldg(reinterpret_cast<const float2*>(wvec + o.wa + c * 16 + 8 + 2 * q));
        float2 h = unpack_bf16(a[c][0]);
        s0 = fmaf(h.x, w0.x, fmaf(h.y, w0.y, s0));
        h = unpack_bf16(a[c][2]);
        s0 = fmaf(h.x, w1.x, fmaf(h.y, w1.y, s0));
        h = unpack_bf16(a[c][1]);
        s8 = fmaf(h.x, w0.x, fmaf(h.y, w0.y, s8));
        h = unpack_bf16(a[c][3]);
        s8 = fmaf(h.x, w1.x, fmaf(h.y, w1.y, s8));
      }
    }
    const float ba = __ldg(wvec + o.ba);
    s0 = quad_sum(s0) + ba;
    s8 = quad_sum(s8) + ba;
    // feat = l9(h8), cast without ReLU.
    product(acc, a, W, W, true, ring);
    epilogue(acc, a, wvec + o.b[8], W, false);
    // l10 on [feat | dir_enc] (H wide): feat with w10a, enc_d with w10b.
    product(acc, a, W, H, true, ring);
    load_frags(a, ed, pl.ldd, KD);
    product(acc, a, KD, H, false, ring);
    // rgb = l11(h10), fp32, from h10 = bf16(ReLU(acc + b10)).
    float c0[3] = {0.f, 0.f, 0.f}, c8[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (c * 16 < H) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // column pair c*16 + 8h + 2q + {0, 1}
          const int col = c * 16 + 8 * h + 2 * q;
          const float2 b = __ldg(reinterpret_cast<const float2*>(wvec + o.b10 + col));
          const float2 v0 = unpack_bf16(pack_bf16(fmaxf(acc[8 * c + 4 * h] + b.x, 0.f),
                                                  fmaxf(acc[8 * c + 4 * h + 1] + b.y, 0.f)));
          const float2 v8 = unpack_bf16(pack_bf16(fmaxf(acc[8 * c + 4 * h + 2] + b.x, 0.f),
                                                  fmaxf(acc[8 * c + 4 * h + 3] + b.y, 0.f)));
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float2 w = __ldg(reinterpret_cast<const float2*>(wvec + o.w11 + ch * H + col));
            c0[ch] = fmaf(v0.x, w.x, fmaf(v0.y, w.y, c0[ch]));
            c8[ch] = fmaf(v8.x, w.x, fmaf(v8.y, w.y, c8[ch]));
          }
        }
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float b = __ldg(wvec + o.b11 + ch);
      c0[ch] = quad_sum(c0[ch]) + b;
      c8[ch] = quad_sum(c8[ch]) + b;
    }
    if (q == 0) {
      const int pa = p0 + row, pb = pa + 8;
      if (pa < n) reinterpret_cast<float4*>(out)[pa] = make_float4(c0[0], c0[1], c0[2], s0);
      if (pb < n) reinterpret_cast<float4*>(out)[pb] = make_float4(c8[0], c8[1], c8[2], s8);
    }
  }
}

template <int FW, int FH, int FKX, int FKD>
__global__ void __launch_bounds__(WS_THREADS, 1)
fused_nerf_wgmma(const __grid_constant__ Maps maps, const float* __restrict__ pts,
                 const float* __restrict__ dirs, const float* __restrict__ wvec,
                 float* __restrict__ out, int n, Dims d, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Bf16Plan pl = bf16_plan(d);
  const uint32_t base = smem_addr(smem);
  Ring ring{base, base + (uint32_t)pl.bars_at, base + (uint32_t)pl.bars_at + 8 * pl.stages,
            (uint32_t)pl.stage_bytes, pl.stages, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty_bar(s), CONSUMERS * WG / 32);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x / WG == CONSUMERS) {  // producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % WG == 0) {
      for (int m = 0; m < MATS; ++m) prefetch_tmap(&maps.m[m]);
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int m = 0; m < MATS; ++m) {
          int K, N;
          mat_shape(m, d, &K, &N);
          for (int k0 = 0; k0 < K; k0 += KCHUNK)
            ring_load(ring, &maps.m[m], k0, (uint32_t)wgmma_rows(N) * KCHUNK * 2);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    consumer<FW, FH, FKX, FKD>(pts, dirs, wvec, out, n, d, tiles, pl, smem, ring);
  }
}

template <int FW = 0, int FH = 0, int FKX = 0, int FKD = 0>
int launch_bf16(const float* pts, const float* dirs, const void* wmat, const float* wvec,
                float* out, int n, Dims d, cudaStream_t stream) {
  const Bf16Plan pl = bf16_plan(d);
  if (pl.stages < 2) return (int)cudaErrorInvalidConfiguration;
  const Offsets o = offsets(d);
  const long at[MATS] = {o.w1, o.w2, o.w3, o.w4, o.w5, o.w6a, o.w6b, o.w7, o.w8, o.w9,
                         o.w10a, o.w10b};
  Maps maps;
  for (int m = 0; m < MATS; ++m) {
    int K, N;
    mat_shape(m, d, &K, &N);
    const int err = make_tmap_sw128(&maps.m[m], static_cast<const __nv_bfloat16*>(wmat) + at[m],
                                    2, N, K, wgmma_rows(N), KCHUNK);
    if (err != 0) return err;
  }
  int sms;
  int err = sm_count(&sms);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(fused_nerf_wgmma<FW, FH, FKX, FKD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.total);
  if (err != 0) return err;
  const int tiles = (n + WS_TILE - 1) / WS_TILE;
  fused_nerf_wgmma<FW, FH, FKX, FKD><<<ws_grid(n, sms), WS_THREADS, pl.total, stream>>>(
      maps, pts, dirs, wvec, out, n, d, tiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32: FFMA

constexpr int TILE = 64;  // points per block

// Dynamic shared-memory plan, in bytes: two activation buffers [TILE, W+PAD],
// enc_x [TILE, KX+PAD], enc_d [TILE, KD+PAD] and sigma [TILE].
__host__ __device__ inline void smem_plan(const Dims& d, size_t* off_b, size_t* off_ex,
                                          size_t* off_ed, size_t* off_sig, size_t* total) {
  size_t p = 0;
  const size_t act = align128((size_t)TILE * (d.W + PAD) * sizeof(float));
  *off_b = p + act;
  p += 2 * act;
  *off_ex = p;
  p += align128((size_t)TILE * (d.KX + PAD) * sizeof(float));
  *off_ed = p;
  p += align128((size_t)TILE * (d.KD + PAD) * sizeof(float));
  *off_sig = p;
  p += align128(TILE * sizeof(float));
  *total = p;
}

// One block per SM fits in shared memory, so its registers need not leave
// room for a second.
__global__ void __launch_bounds__(THREADS, 1)
fused_nerf_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                  const float* __restrict__ wmat, const float* __restrict__ wvec,
                  float* __restrict__ out, int n, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off_b, off_ex, off_ed, off_sig, total;
  smem_plan(d, &off_b, &off_ex, &off_ed, &off_sig, &total);
  float* bufA = reinterpret_cast<float*>(smem);
  float* bufB = reinterpret_cast<float*>(smem + off_b);
  float* enc_x = reinterpret_cast<float*>(smem + off_ex);
  float* enc_d = reinterpret_cast<float*>(smem + off_ed);
  float* sig = reinterpret_cast<float*>(smem + off_sig);
  const int ld = d.W + PAD, ldx = d.KX + PAD, ldd = d.KD + PAD;
  const Offsets o = offsets(d);
  const int p0 = blockIdx.x * TILE;

  encode_tile<float, TILE>(pts, dirs, p0, n, d, enc_x, ldx, enc_d, ldd);
  __syncthreads();
  // Activations ping-pong: h1 A, h2 B, ..., h8 B, feat A, h10 B.
  float* const h[10] = {bufA, bufB, bufA, bufB, bufA, bufB, bufA, bufB, bufA, bufB};
  forward_tile<TILE>(enc_x, ldx, enc_d, ldd, wmat, wvec, d, o, h, ld, sig);
  // rgb = l11(h10), fp32; write (r, g, b, sigma) for the points that exist.
  for (int idx = threadIdx.x; idx < TILE * 3; idx += THREADS) {
    const int r = idx / 3, c = idx % 3;
    const int p = p0 + r;
    if (p >= n) continue;
    float s = 0.f;
    for (int k = 0; k < d.H; ++k) s = fmaf(bufB[r * ld + k], wvec[o.w11 + (long)c * d.H + k], s);
    out[4L * p + c] = s + wvec[o.b11 + c];
  }
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int p = p0 + r;
    if (p < n) out[4L * p + 3] = sig[r];
  }
}

int launch_fp32(const float* pts, const float* dirs, const void* wmat, const float* wvec,
                float* out, int n, Dims d, cudaStream_t stream) {
  size_t off_b, off_ex, off_ed, off_sig, total;
  smem_plan(d, &off_b, &off_ex, &off_ed, &off_sig, &total);
  cudaError_t err = cudaFuncSetAttribute(fused_nerf_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TILE - 1) / TILE;
  fused_nerf_kernel<<<blocks, THREADS, total, stream>>>(
      pts, dirs, static_cast<const float*>(wmat), wvec, out, n, d);
  return (int)cudaGetLastError();
}

// The lego net (trunk 256, head 128, L = 10 / 4: KX = 64, KD = 32) gets its
// widths at compile time; other widths read them at run time, where ptxas
// serialises the wgmmas of a product behind the width tests.
inline bool bf16_fixed(const Dims& d) {
  return d.W == 256 && d.H == 128 && d.KX == 64 && d.KD == 32;
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

// The bf16 launch for n points on the current device, so the host can check
// its own arithmetic (ops/fused_mlp.py::bf16_launch_plan): plan[0..4] =
// blocks, threads, dynamic shared-memory bytes, weight stages, widths fixed
// at compile time (1) or not (0). Returns a cudaError_t value.
int cvnerf_fused_nerf_bf16_plan(int n, int W, int H, int Lx, int Ld, int* plan) {
  const Dims d = make_dims(W, H, Lx, Ld);
  const Bf16Plan pl = bf16_plan(d);
  int sms;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  plan[0] = ws_grid(n, sms);
  plan[1] = WS_THREADS;
  plan[2] = (int)pl.total;
  plan[3] = pl.stages;
  plan[4] = bf16_fixed(d) ? 1 : 0;
  return 0;
}

// out[n, 4] = fused encode -> MLP of (pts[n, 3], dirs[n, 3]). bf16 != 0
// selects the bf16 (wgmma) kernel. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success); does not synchronise.
int cvnerf_fused_nerf_forward(const float* pts, const float* dirs, const void* wmat,
                              const float* wvec, float* out, int n, int W, int H, int Lx,
                              int Ld, int bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_fp32(pts, dirs, wmat, wvec, out, n, d, s);
  if (bf16_fixed(d)) return launch_bf16<256, 128, 64, 32>(pts, dirs, wmat, wvec, out, n, d, s);
  return launch_bf16<>(pts, dirs, wmat, wvec, out, n, d, s);
}

}  // extern "C"
