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
// tensor cores (989 TFLOP/s dense bf16) bound the bf16 kernel: 1.887 ms for
// a fine chunk of 1,572,864 points. The cost that stands between a kernel
// and that bound is the weights: all 1.19 MB of them (bf16) pass through
// every tile of points, so a tile of M points reads each weight byte once
// per M FLOP. At M = 64 with each warp fetching its own fragments from L2
// (the first version: nvcuda::wmma 16x16x16, weights re-read per 16x16
// output tile, ~74 KB of L2 reads a point) the kernel sat at ~4.5% of the
// bound, limited by the latency of those unstaged loads.
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
// fp32 design (fused_nerf_ffma; the --no-bf16 path: every MLP query of an
// fp32 frame or train step). True fp32 products on the FFMA pipe, never
// TF32 (the JAX kernel demands Precision.HIGHEST), so what bounds it is the
// FFMA rate: 1,186,816 FLOP a point at 67 TFLOP/s, 1.162 ms at n = 65,573.
// The first version walked 64-point tiles with the weights loaded from L2
// inside the FFMA loop (16 loads per 64 FFMAs a thread, 8 warps an SM to
// hide them, 2.4 MB of weights re-read per block) and sat at 15% of that
// bound. This one is nerf_ffma.cuh's block:
//   * a persistent grid of one block per SM walks the 64-point tiles; one
//     producer warp streams every layer's weights, tile after tile, in
//     16-row K-slabs (contiguous in the fp32 [in, out] packing) by bulk
//     copies into a ring of up to 8 stages, so the FFMA loop never waits
//     on L2;
//   * eight consumer warps each hold 8 x 8 register micro-tiles (8 points
//     x 8 columns) and read both operands from shared memory by 16-byte
//     loads: 4 loads, one wavefront each, per 64 FFMAs; the activations
//     lie [k][64 points], swizzled, in one buffer that each layer's output
//     overwrites from registers after a barrier; the encodings stay in two
//     more; the l6 skip and the l10 concat are split products into one
//     accumulator; the lego head (128 wide) takes one column chunk a
//     thread, so every thread stays busy;
//   * sigma and rgb are per-thread partial dots over the thread's columns
//     of h8 and h10 in registers, summed by shuffles over a warp's column
//     groups and then over the 4 warp columns in a fixed order; no atomics,
//     a fixed tile -> block map: two launches are bitwise equal.
// What the TPU kernel did for its matrix unit (mantissa-split phase matmul,
// the [id|sin|cos] row permutation, the transposed [channels, T] layout, the
// 8-row output padding) has no counterpart here: the encoding keeps
// freq_encode's own layout [x | sin_0 cos_0 | ...], zero-padded to 16.
//
// Operand layout: nerf_common.cuh (shared with the backward and int8
// kernels). The warp-specialised block, its register budget and the staged
// encoding: nerf_wgmma.cuh (shared with the int8 kernel), and in its
// namespace bf16wg the shared-memory plan, product, load_frags, epilogue and
// encode_wg (shared with the backward's pass 1, fused_mlp_bwd.cu). The fp32
// block: nerf_ffma.cuh (shared with the fp32 backward's pass 1). wgmma,
// TMA, bulk copies, mbarrier helpers and the ring of weight stages:
// hopper.cuh.

#include "nerf_ffma.cuh"

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
// fused_nerf_ffma: nerf_ffma.cuh's block. Its own shared memory: the head
// partials hp [4 warp columns][64 points][r, g, b, sigma].
constexpr size_t HEAD_BYTES = 4 * ffma::TILE * 4 * sizeof(float);

__host__ __device__ inline ffma::Plan fp32_plan(const Dims& d) {
  return ffma::plan(d, HEAD_BYTES);
}

// hp[warp column][point(i)][ch] <- the sum of part[i] over the warp's 8
// column groups (every lane calls it; the shuffles are the warp's).
__device__ __forceinline__ void head_part(float (&part)[8], float* hp, int ch,
                                          const ffma::Thr& t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = ffma::row_sum8(part[i]);
  if ((t.lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) hp[((t.warp & 3) * ffma::TILE + t.point(i)) * 4 + ch] = part[i];
  }
}

// part[i] <- sum over this thread's columns below N of v[i][j] w[col(j)].
template <int NCH>
__device__ __forceinline__ void dot_cols(const float (&v)[8][8], const float* __restrict__ w,
                                         int N, float (&part)[8], const ffma::Thr& t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = 0.f;
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc) {
    if (ffma::chunk_in(jc, N, t)) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + 128 * jc + 4 * t.cg));
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) part[i] = fmaf(v[i][4 * jc + jj], ww[jj], part[i]);
    }
  }
}

// The consumer warps' walk over their tiles. FW, FH, FKX, FKD fix the
// widths at compile time (0: read them from d; then every product takes
// both column chunks, and a layer 128 wide or less computes the second
// chunk's unused columns).
template <int FW, int FH, int FKX, int FKD>
__device__ __forceinline__ void fp32_consumer(const float* __restrict__ pts,
                                              const float* __restrict__ dirs,
                                              const float* __restrict__ wvec,
                                              float* __restrict__ out, int n, const Dims& d,
                                              int tiles, const ffma::Plan& pl,
                                              unsigned char* smem, Ring& ring) {
  using namespace ffma;
  constexpr int NW = (FW == 0 || FW > 128) ? 2 : 1;
  constexpr int NH = (FH == 0 || FH > 128) ? 2 : 1;
  const Thr t = thr();
  const int W = FW ? FW : d.W, H = FH ? FH : d.H;
  const int KX = FKX ? FKX : d.KX, KD = FKD ? FKD : d.KD;
  float* buf = reinterpret_cast<float*>(smem + pl.act_at);
  float* ex = reinterpret_cast<float*>(smem + pl.ex_at);
  float* ed = reinterpret_cast<float*>(smem + pl.ed_at);
  float* raw = reinterpret_cast<float*>(smem + pl.raw_at);
  float* hp = reinterpret_cast<float*>(smem + pl.own_at);
  const Stages st{reinterpret_cast<const float*>(smem), (int)(pl.stage_bytes / 4)};
  const Offsets o = offsets(d);
  zero_pad_rows(d, ex, ed);
  float acc[8][8], part[8];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * TILE;
    named_sync(BAR, CONSUMER_THREADS);  // the last tile's reads of ex, ed, raw, hp are done
    encode(pts, dirs, p0, n, d, ex, ed, raw);
    // l1: enc_x (buf is free: the last tile's products are done)
    ffma::product<NW>(acc, ex, KX, W, true, ring, st, t);
    bias_act<NW>(acc, wvec + o.b[0], W, true, t);
    store_rows<NW>(acc, buf, W, t);
    named_sync(BAR, CONSUMER_THREADS);
    // l2..l9 (bias l at wvec + l W); l6 on [xyz_enc | h5]: h5 with w6a, then
    // enc_x with w6b, one accumulator; l9 (feat) without ReLU.
#pragma unroll 1
    for (int l = 1; l < 9; ++l) {
      ffma::product<NW>(acc, buf, W, W, true, ring, st, t);
      if (l == 5) ffma::product<NW>(acc, ex, KX, W, false, ring, st, t);
      bias_act<NW>(acc, wvec + l * W, W, l < 8, t);
      if (l == 7) {  // sigma = h8 . wa + ba, fp32
        dot_cols<NW>(acc, wvec + o.wa, W, part, t);
        head_part(part, hp, 3, t);
      }
      named_sync(BAR, CONSUMER_THREADS);  // every thread has read buf
      store_rows<NW>(acc, buf, W, t);
      named_sync(BAR, CONSUMER_THREADS);
    }
    // l10 on [feat | dir_enc] (H wide), then rgb = l11(h10) from registers.
    ffma::product<NH>(acc, buf, W, H, true, ring, st, t);
    ffma::product<NH>(acc, ed, KD, H, false, ring, st, t);
    bias_act<NH>(acc, wvec + o.b10, H, true, t);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      dot_cols<NH>(acc, wvec + o.w11 + ch * H, H, part, t);
      head_part(part, hp, ch, t);
    }
    named_sync(BAR, CONSUMER_THREADS);
    if (threadIdx.x < TILE) {  // (r, g, b, sigma), the warp columns summed in order
      const int p = threadIdx.x;
      float v[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float s = hp[p * 4 + ch];
#pragma unroll
        for (int wc = 1; wc < 4; ++wc) s += hp[(wc * TILE + p) * 4 + ch];
        v[ch] = s + __ldg(wvec + (ch < 3 ? o.b11 + ch : o.ba));
      }
      if (p0 + p < n) reinterpret_cast<float4*>(out)[p0 + p] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int FW, int FH, int FKX, int FKD>
__global__ void __launch_bounds__(ffma::THREADS, 1)
fused_nerf_ffma(const float* __restrict__ pts, const float* __restrict__ dirs,
                const float* __restrict__ wmat, const float* __restrict__ wvec,
                float* __restrict__ out, int n, Dims d, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ffma::Plan pl = fp32_plan(d);
  Ring ring = ffma::make_ring(smem, pl);
  __syncthreads();
  if (threadIdx.x >= ffma::CONSUMER_THREADS) {  // the producer warp: its lane 0 streams
    if (threadIdx.x == ffma::CONSUMER_THREADS) {
      const Offsets o = offsets(d);
      const long at[MATS] = {o.w1, o.w2, o.w3, o.w4, o.w5, o.w6a, o.w6b, o.w7, o.w8, o.w9,
                             o.w10a, o.w10b};
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int m = 0; m < MATS; ++m) {
          int K, N;
          mat_shape(m, d, &K, &N);
          ffma::stream_block(ring, wmat + at[m], K, N);
        }
      }
    }
    return;
  }
  fp32_consumer<FW, FH, FKX, FKD>(pts, dirs, wvec, out, n, d, tiles, pl, smem, ring);
}

template <int FW = 0, int FH = 0, int FKX = 0, int FKD = 0>
int launch_fp32(const float* pts, const float* dirs, const void* wmat, const float* wvec,
                float* out, int n, Dims d, cudaStream_t stream) {
  const ffma::Plan pl = fp32_plan(d);
  if (pl.stages < 3) return (int)cudaErrorInvalidConfiguration;
  int sms;
  int err = sm_count(&sms);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(fused_nerf_ffma<FW, FH, FKX, FKD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.total);
  if (err != 0) return err;
  const int tiles = (n + ffma::TILE - 1) / ffma::TILE;
  fused_nerf_ffma<FW, FH, FKX, FKD><<<ffma::grid(n, sms), ffma::THREADS, pl.total, stream>>>(
      pts, dirs, static_cast<const float*>(wmat), wvec, out, n, d, tiles);
  return (int)cudaGetLastError();
}

// The lego net (trunk 256, head 128, L = 10 / 4: KX = 64, KD = 32) gets its
// widths at compile time; other widths read them at run time, where ptxas
// serialises the wgmmas of a product behind the width tests (bf16) or every
// product takes both column chunks (fp32).
inline bool fixed_widths(const Dims& d) {
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
  plan[4] = fixed_widths(d) ? 1 : 0;
  return 0;
}

// The fp32 launch for n points on the current device, so the host can check
// its own arithmetic (ops/fused_mlp.py::fp32_launch_plan): plan[0..4] as
// cvnerf_fused_nerf_bf16_plan's. Returns a cudaError_t value.
int cvnerf_fused_nerf_fp32_plan(int n, int W, int H, int Lx, int Ld, int* plan) {
  const Dims d = make_dims(W, H, Lx, Ld);
  const ffma::Plan pl = fp32_plan(d);
  int sms;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  plan[0] = ffma::grid(n, sms);
  plan[1] = ffma::THREADS;
  plan[2] = (int)pl.total;
  plan[3] = pl.stages;
  plan[4] = fixed_widths(d) ? 1 : 0;
  return 0;
}

// out[n, 4] = fused encode -> MLP of (pts[n, 3], dirs[n, 3]). bf16 != 0
// selects the bf16 (wgmma) kernel, else the fp32 (FFMA) one. Launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success);
// does not synchronise.
int cvnerf_fused_nerf_forward(const float* pts, const float* dirs, const void* wmat,
                              const float* wvec, float* out, int n, int W, int H, int Lx,
                              int Ld, int bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (fixed_widths(d)) return launch_fp32<256, 128, 64, 32>(pts, dirs, wmat, wvec, out, n, d, s);
    return launch_fp32<>(pts, dirs, wmat, wvec, out, n, d, s);
  }
  if (fixed_widths(d)) return launch_bf16<256, 128, 64, 32>(pts, dirs, wmat, wvec, out, n, d, s);
  return launch_bf16<>(pts, dirs, wmat, wvec, out, n, d, s);
}

}  // extern "C"
