// Backward of the fused frequency-encode -> NeRF MLP, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// ops/pallas/fused_mlp_bwd.py::_bwd_pallas (pallas_call at fused_mlp_bwd.py:207,
// body _bwd_kernel :52-151), the VJP of fused_nerf_train_apply. Given the
// upstream g[n, 4] (d rgb, d sigma) it recomputes the forward of each tile of
// points, then backpropagates through the 12 layers and returns the weight
// and bias gradients summed over all points, fp32, in the packed operand
// layout (nerf_common.cuh). Gradients reach the parameters only: d(points)
// and d(viewdirs) are zero by contract, and layer 1's input gradient is never
// formed. The cast points are the JAX kernel's:
//   * each ReLU mask is h > 0 of the recomputed, compute-dtype-rounded h;
//   * each upstream delta is rounded to the compute dtype before it enters
//     either product (wgrad and dgrad); bias gradients sum the fp32 delta;
//   * l9 has no ReLU; sigma's delta enters h8 through wa; l6 splits into its
//     hidden part (dgrad to h5) and its xyz-encoding part (wgrad only); l10
//     into its feat part and its dir-encoding part (wgrad only).
//
// What bounds it on this card: operations. The least work is the weight
// gradient of all 12 layers plus the input gradient of all but l1, 2,302,208
// FLOP a point at full width (0.610 ms for a train step's 262,144 points at
// 989 TFLOP/s); recomputing the forward, as the JAX kernel does so that no
// activation is kept between the forward and the backward pass, makes it
// 3,489,024. What bounds this design besides: the stash. A weight gradient
// sums over all points, so it is one product with K = n (done per tile it
// would read and write the whole gradient once per tile of points); pass 1
// writes its operands, 9,664 B a point in bf16, and the weight-gradient pass
// reads them back: 2.53 GB a train step, at least 0.76 + 0.76 ms at
// 3.35 TB/s, above the operation bound. Pass 1 writes each byte once, from
// registers, while its products run; the weight-gradient pass reads a
// weight block's deltas once and its inputs once per 128 outputs. In fp32
// (FFMA at 67 TFLOP/s) the operations bound it, recompute included: 3.415
// ms at n = 65,573, against 0.76 ms to write and read its 19,328 B a point
// of stash.
//
// Per chunk of up to CHUNK_POINTS points, pass 1 then pass 2; then one
// reduction:
//   1. pass 1, bf16: fused_nerf_bwd_wgmma, the forward kernel's block
//      (nerf_wgmma.cuh): a persistent grid of one block per SM walks tiles
//      of 128 points; one TMA producer warpgroup streams, per tile and in
//      one fixed order, the 12 forward blocks of wmat and then the 9
//      input-gradient blocks (w10a, w9, w8, w7, w6a, w5, w4, w3, w2) of the
//      same weights transposed to [in, out] (ops/fused_mlp_bwd.py::
//      in_out_matrices, a bf16 copy built once per call, 1.19 MB at full
//      width, so that the forward's K-major descriptors and 32 KB stages
//      serve both directions) through the ring of shared-memory stages; two
//      consumer warpgroups of 64 points each run wgmma m64n64k16 with every
//      activation and every delta in registers:
//        * the recompute is the forward consumer's; each epilogue also
//          stores the rounded h to the stash, keeps the ReLU mask h > 0 as
//          bits at the thread's own accumulator positions in shared memory
//          (the accumulator of d h_i has h_i's fragment layout, so each
//          thread reads back exactly the bits it wrote: 4 words a layer,
//          h1..h8, 16 KB a warpgroup), and forms what g already allows: the
//          wa gradient at h8; the w11 gradient and d h10 = (round(g_rgb)
//          w11^T) (h10 > 0) at h10, in accumulator layout;
//        * the input gradients are nine products d_prev[64, in] =
//          round(d)[64, out] W[out, in], the rounded delta the register A
//          fragment packed from the last accumulator, as the forward does
//          with its activations; each epilogue adds wa[col] round(d
//          sigma[row]) at d h8, applies the mask, rounds to bf16 into the
//          next A fragment and the stash, and forms the fp32 column sums of
//          the bias gradient;
//        * column sums (biases, wa, w11) reduce over a warp's rows by a
//          fixed __shfl_xor_sync tree (a reduce-scatter over the lane bits
//          that select rows) into the warp's own fp32 vector slab; at the
//          end of the launch each block sums its 8 warp slabs, in order,
//          into its block slab (a per-block shared accumulator would not
//          fit beside 3 ring stages at the widest bands);
//        * stash stores come straight from the A fragments, without shared
//          memory: a 4 x 4 transpose within each quad of lanes by shuffles
//          gives each lane 16 contiguous bytes of a row, written by one
//          16-byte streaming store (whole 32-byte sectors; 4-byte stores of
//          the fragments as they lie wrote half sectors and took 58% of the
//          pass, scripts/backward_cost_probe.py);
//      pass 1, fp32 (the --no-bf16 path): fused_nerf_bwd_ffma, the fp32
//      forward's block (nerf_ffma.cuh; FFMA, never TF32, so the FFMA rate
//      bounds it: the recompute and the input gradients are 2,302,208 FLOP
//      a point, 2.253 ms at n = 65,573 and 67 TFLOP/s; its fp32 stash,
//      19,328 B a point, takes 0.38 ms to write at 3.35 TB/s, and the
//      stores run beside the products). The first version kept ten fp32
//      activations, two deltas and the encodings of a tile in shared
//      memory, so a tile held 16 points, and read the weights from L2
//      inside its FFMA loops: 5.8% of the bound. Now a persistent grid
//      walks 64-point tiles; the producer warp streams, per tile and in
//      one fixed order, the 12 forward blocks and then the 9 input-gradient
//      blocks of ops/fused_mlp_bwd.py::out_in_matrices ([out, in], so a
//      K-slab is contiguous rows) through the ring of bulk-copied stages;
//      the eight consumer warps hold 8 x 8 micro-tiles in registers:
//        * the recompute is the fp32 forward's walk; each epilogue stores
//          h to the stash from registers (16-byte streaming stores: a
//          warp writes 4 rows of 128 contiguous bytes) and keeps its ReLU
//          mask as bits (bit 8 (i % 4) + j of word i / 4 of the thread's
//          slot, 16 KB for h1..h8), so one activation buffer suffices;
//        * the head sums (wa at h8; w11, b10 and d h10 at h10, all from
//          registers) and every bias sum are fp32 column sums in a fixed
//          order: the thread's 8 points, then a shuffle tree over the 4
//          lanes that share the column group, into the slab of the
//          block's row of warps (two a block, no float atomics);
//        * each input gradient d_prev[64, in] = d[64, out] W[out, in] reads
//          the last delta from the shared buffer (written over its input
//          after a barrier) with the forward's micro-tiles.
//   2. the weight gradients G = D^T H of each weight block over the
//      chunk's points, split-K over the points, each split writing its own
//      fp32 partial: in bf16 wgrad_wgmma (TMA-fed wgmma on the stash as it
//      lies, through wgmma's transpose bits; 128 x 256 output tiles), in
//      fp32 wgrad_ffma (FFMA, never TF32; 128 x 128 output tiles of 8 x 8
//      micro-tiles, both operands [points, width] as they lie, each stage
//      32 points' row pieces by cp.async, a ring of 3 stages; the first
//      version's 64 x 64 tiles of 4 x 4 micro-tiles with one synchronous
//      buffer took ~4 ms at n = 65,573).
//   3. reduce_slabs sums the partials (and the vector slabs) in a fixed
//      order. No float atomics anywhere, and a fixed tile -> block map, so
//      the same inputs give bitwise-identical gradients on every launch (the
//      TPU kernel's sequential-grid accumulation does not carry over to a
//      parallel grid).

#include "nerf_ffma.cuh"

namespace {

using namespace cvnerf;
using namespace cvnerf::bf16wg;
using namespace hopper;

constexpr int CHUNK_POINTS = 1 << 18;  // points per pass 1 + pass 2
constexpr int SPLIT_POINTS = 16384;    // points per split-K partial (about)
constexpr int MAX_SPLITS = 16;

// ------------------------------------------------------------ the stash
// Operands of the weight gradients, each [rows, width] row-major in the
// compute dtype. Layer inputs: 0 enc_x (KX), 1 enc_d (KD), 2..9 h1..h8,
// 10 feat (W). Deltas (the rounded d of each layer's output): 0..7 d1..d8,
// 8 d feat (W), 9 d h10 (H). Rows are rounded up to whole tiles; rows past
// n carry g = 0, so every delta there is exactly 0.
constexpr int N_ACT = 11, N_DEL = 10;

__host__ __device__ inline int act_width(int a, const Dims& d) {
  return a == 0 ? d.KX : a == 1 ? d.KD : d.W;
}
__host__ __device__ inline int del_width(int k, const Dims& d) { return k == 9 ? d.H : d.W; }

struct Stash {
  long act[N_ACT], del[N_DEL], total;  // element offsets
  long wstride;                        // elements of a W-wide operand
};

__host__ __device__ inline Stash stash_plan(const Dims& d, long rows) {
  Stash s;
  long p = 0;
  for (int a = 0; a < N_ACT; ++a) { s.act[a] = p; p += rows * act_width(a, d); }
  for (int k = 0; k < N_DEL; ++k) { s.del[k] = p; p += rows * del_width(k, d); }
  s.wstride = rows * d.W;
  s.total = p;
  return s;
}

// ------------------------------------------------------------ pass 1, bf16
constexpr int MASKED = 8;          // layers whose ReLU masks the chain reads back: h1..h8
constexpr int MASK_WORDS = 4;      // 128 bits a thread: one per accumulator register
constexpr int DGRAD = 9;           // input-gradient blocks: w10a, w9, w8, w7, w6a, w5..w2
constexpr int WARP_SLABS = CONSUMERS * WG / 32;  // vector slabs of a block's warps
constexpr int BOTH = 3;            // named barrier of both consumer warpgroups
// A consumer warpgroup's region (bf16_plan's wg_bytes), ordered so that all
// but enc_d lie at constant offsets: its rows' g [64][4] (fp32), the masks
// [MASKED][MASK_WORDS][WG] (one word per thread, word-major), the raw
// inputs, enc_x, enc_d.
constexpr size_t G_BYTES = WG_ROWS * 4 * sizeof(float);
constexpr size_t OWN_BYTES = G_BYTES + (size_t)MASKED * MASK_WORDS * WG * 4;
constexpr size_t EX_AT = OWN_BYTES + RAW_BYTES;

struct BwdMaps {
  CUtensorMap fwd[MATS];  // wmat's blocks [out, in], the forward's order
  CUtensorMap dg[DGRAD];  // in_out's blocks [in, out], the input gradients' order
};

__host__ __device__ inline Bf16Plan bwd_plan(const Dims& d) { return bf16_plan(d, OWN_BYTES); }

// Input-gradient block j: its offset (the same in wmat and in in_out) and
// fan-out, the depth of its product.
__host__ __device__ inline long dgrad_at(int j, const Offsets& o) {
  switch (j) {
    case 0: return o.w10a;
    case 1: return o.w9;
    case 2: return o.w8;
    case 3: return o.w7;
    case 4: return o.w6a;
    case 5: return o.w5;
    case 6: return o.w4;
    case 7: return o.w3;
    default: return o.w2;
  }
}
__host__ __device__ inline int dgrad_k(int j, const Dims& d) { return j == 0 ? d.H : d.W; }

// p, opaque to the compiler: an address formed from it is formed where it
// is used, not hoisted out of the tile loop into a register of its own
// (a dozen 64-bit stash, slab and weight addresses would not fit beside the
// accumulator and the A fragment).
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The vector offsets of widths W, H (nerf_common.cuh Offsets: b[l] = l W,
// then b10, wa, w11, ba, b11), formed where they are used: compile-time
// constants at fixed widths, and at run-time widths no register is held
// across the tile loop for them.
struct VecAt {
  int W, H;
  __device__ __forceinline__ int b10() const { return 9 * opaque(W); }
  __device__ __forceinline__ int wa() const { return 9 * opaque(W) + H; }
  __device__ __forceinline__ int w11() const { return 10 * opaque(W) + H; }
  __device__ __forceinline__ int ba() const { return 10 * opaque(W) + 4 * H; }
  __device__ __forceinline__ int b11() const { return 10 * opaque(W) + 4 * H + 4; }
};

// Bit 0: the low bf16 of a packed pair is > 0; bit 1: the high one.
__device__ __forceinline__ uint32_t pos_bits(uint32_t p) {
  return (uint32_t)((p & 0xFFFFu) - 1u < 0x7FFFu) | ((uint32_t)((int)p > 0xFFFF) << 1);
}

// Keep the ReLU mask of a layer's packed activations a (N wide) in msk:
// bit 8 c + j of the thread's 128 is h > 0 at accumulator register 8 c + j
// (a[c][k] packs registers 8 c + 2 k and 8 c + 2 k + 1), word c / 4.
__device__ __forceinline__ void keep_mask(const uint32_t (&a)[16][4], int N, uint32_t* msk) {
  const int tid = threadIdx.x % WG;
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) {
    uint32_t bits = 0;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * w + cc;
      if (c * 16 < N)
        bits |= (pos_bits(a[c][0]) | (pos_bits(a[c][1]) << 2) | (pos_bits(a[c][2]) << 4) |
                 (pos_bits(a[c][3]) << 6))
                << (8 * cc);
    }
    msk[w * WG + tid] = bits;
  }
}

// Rows row, row + 8 of the warpgroup's 64 at p0 of a stash operand dst
// [rows, N] <- the packed fragments a. Per 16-column group c a quad's four
// lanes hold both rows' 32 bytes, lane q in a[c][0..3] (columns 16 c + 2 q
// and + 1 of row and row + 8, then the same at 16 c + 8 + 2 q). A 4 x 4
// transpose within the quad (two shuffle rounds, each swapping one bit of
// the lane with one bit of the register index) leaves lane q with 16
// contiguous bytes, row + 8 (q & 1), columns 16 c + 8 (q >> 1) .. + 7, for
// one 16-byte store: a warp writes whole 32-byte sectors, and streaming
// (st.global.cs), since the stash is read back only after the pass.
__device__ __forceinline__ void stash_frags(const uint32_t (&a)[16][4], __nv_bfloat16* dst,
                                            int N, int p0) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32, q = lane % 4;
  const bool b0 = (q & 1) != 0, b1 = (q & 2) != 0;
  __nv_bfloat16* out = dst + (long)(p0 + warp * 16 + lane / 4 + 8 * (q & 1)) * N + 8 * (q >> 1);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c * 16 < N) {
      uint32_t r0 = a[c][0], r1 = a[c][1], r2 = a[c][2], r3 = a[c][3];
      {  // lane bit 0 <-> register bit 0
        const uint32_t x = __shfl_xor_sync(0xffffffffu, b0 ? r0 : r1, 1);
        const uint32_t y = __shfl_xor_sync(0xffffffffu, b0 ? r2 : r3, 1);
        if (b0) {
          r0 = x;
          r2 = y;
        } else {
          r1 = x;
          r3 = y;
        }
      }
      {  // lane bit 1 <-> register bit 1
        const uint32_t x = __shfl_xor_sync(0xffffffffu, b1 ? r0 : r2, 2);
        const uint32_t y = __shfl_xor_sync(0xffffffffu, b1 ? r1 : r3, 2);
        if (b1) {
          r0 = x;
          r1 = y;
        } else {
          r2 = x;
          r3 = y;
        }
      }
      __stcs(reinterpret_cast<uint4*>(out + 16 * c), make_uint4(r0, r1, r2, r3));
    }
  }
}

// The warpgroup's 64 rows of an encoding E [64, ld] (shared) to rows p0..
// of a stash operand [rows, width], 16 bytes at a time.
__device__ __forceinline__ void stash_enc(const __nv_bfloat16* E, int ld, __nv_bfloat16* dst,
                                          int width, int p0) {
  const int vw = width / 8;
  for (int i = threadIdx.x % WG; i < WG_ROWS * vw; i += WG) {
    const int r = i / vw, c = (i % vw) * 8;
    __stcs(reinterpret_cast<uint4*>(dst + (long)(p0 + r) * width + c),
           *reinterpret_cast<const uint4*>(E + r * ld + c));
  }
}

// dst[col] += the sum over this warp's 16 rows of val(c, h, e), the thread's
// two rows' values at column 16 c + 8 h + 2 (lane % 4) + e already added,
// for the 32 columns of block b below N (dst: the warp's own slab). A
// reduce-scatter over the lane bits that select rows (xor 16, 8, 4; a fixed
// order) leaves lane l with column 32 b + 16 l4 + 8 l3 + 2 (l % 4) + l2,
// (l4 l3 l2) the bits of l / 4.
template <class Val>
__device__ __forceinline__ void col_sum_block(int b, int N, float* dst, const Val& val) {
  const int lane = threadIdx.x % 32, v = lane / 4;
  const int col = 32 * b + 16 * (v >> 2) + 8 * ((v >> 1) & 1) + 2 * (lane % 4) + (v & 1);
  const float old = col < N ? dst[col] : 0.f;
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 2 * b + i / 4;
    s[i] = c * 16 < N ? val(c, (i / 2) % 2, i % 2) : 0.f;
  }
#pragma unroll
  for (int m = 16, half = 4; m >= 4; m /= 2, half /= 2) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? s[i] : s[i + half], keep = up ? s[i + half] : s[i];
      s[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  if (col < N) dst[col] = old + s[0];
}

template <class Val>
__device__ __forceinline__ void col_sums(int N, float* dst, const Val& val) {
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (b * 32 < N) col_sum_block(b, N, dst, val);
}

// dst[col] += sum over the warp's rows of g_row h[row, col] for the packed
// activations a (N wide); g0, g8: the rounded upstream of rows row, row + 8.
__device__ __forceinline__ void head_grad(const uint32_t (&a)[16][4], int N, float g0, float g8,
                                          float* dst) {
  col_sums(N, dst, [&](int c, int h, int e) {
    const float2 v0 = unpack_bf16(a[c][2 * h]), v8 = unpack_bf16(a[c][2 * h + 1]);
    return fmaf(g8, e ? v8.y : v8.x, g0 * (e ? v0.y : v0.x));
  });
}

// The input-gradient epilogue of a layer N wide: acc <- (acc + wa[col]
// round(d sigma[row])) (h > 0) in fp32 (WA: s0, s8 the rounded d sigma of
// rows row, row + 8; MASK: the layer's bits, keep_mask's layout); a <-
// bf16(acc), stored to the stash operand dst; the fp32 column sums added to
// the bias gradient bias (the warp's slab). 32 columns at a time, so that
// the accumulator registers of a block are free once its sums are formed.
template <bool WA, bool MASK>
__device__ __forceinline__ void delta_epilogue(float (&acc)[128], uint32_t (&a)[16][4], int N,
                                               const uint32_t* msk,
                                               const float* __restrict__ wa, float s0,
                                               float s8, __nv_bfloat16* dst, int p0,
                                               float* bias) {
  const int tid = threadIdx.x % WG, q = threadIdx.x % 4;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b * 32 < N) {
#pragma unroll
      for (int c = 2 * b; c < 2 * b + 2; ++c) {
        if (c * 16 < N) {
          if (WA) {
            const float2 w0 = __ldg(reinterpret_cast<const float2*>(wa + c * 16 + 2 * q));
            const float2 w1 = __ldg(reinterpret_cast<const float2*>(wa + c * 16 + 8 + 2 * q));
            const float w[4] = {w0.x, w0.y, w1.x, w1.y};
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                acc[8 * c + 4 * h + e] = fmaf(w[2 * h + e], s0, acc[8 * c + 4 * h + e]);
                acc[8 * c + 4 * h + 2 + e] = fmaf(w[2 * h + e], s8, acc[8 * c + 4 * h + 2 + e]);
              }
          }
          if (MASK) {
            const uint32_t m = msk[(c / 4) * WG + tid] >> (8 * (c % 4));
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[8 * c + j] = ((m >> j) & 1u) ? acc[8 * c + j] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[c][k] = pack_bf16(acc[8 * c + 2 * k], acc[8 * c + 2 * k + 1]);
        }
      }
      col_sum_block(b, N, bias, [&](int c, int h, int e) {
        return acc[8 * c + 4 * h + e] + acc[8 * c + 4 * h + 2 + e];
      });
    }
  }
  stash_frags(a, dst, N, p0);
}

// The consumer warpgroups' walk over their tiles: the forward, keeping what
// the chain and the weight gradients need, then the input gradients. FW,
// FH, FKX, FKD fix the widths at compile time (0: read them from d).
template <int FW, int FH, int FKX, int FKD>
__device__ __forceinline__ void bwd_consumer(const float* __restrict__ pts,
                                             const float* __restrict__ dirs,
                                             const float* __restrict__ gout,
                                             const float* __restrict__ wvec,
                                             float* __restrict__ wslabs, long vstride,
                                             __nv_bfloat16* __restrict__ stash, const Stash& sp,
                                             int n, const Dims& d, int tiles, const Bf16Plan& pl,
                                             unsigned char* smem, Ring& ring) {
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = threadIdx.x % 32, q = lane % 4;
  const int row = warp * 16 + lane / 4;  // this thread's rows: row, row + 8
  const int W = FW ? FW : d.W, H = FH ? FH : d.H;
  const int KX = FKX ? FKX : d.KX, KD = FKD ? FKD : d.KD;
  const int ldx = KX + ENC_PAD, ldd = KD + ENC_PAD;
  unsigned char* mine = smem + pl.enc_at + wg * pl.wg_bytes;
  float* gs = reinterpret_cast<float*>(mine);
  uint32_t* msk = reinterpret_cast<uint32_t*>(mine + G_BYTES);
  float* raw = reinterpret_cast<float*>(mine + OWN_BYTES);
  __nv_bfloat16* ex = reinterpret_cast<__nv_bfloat16*>(mine + EX_AT);
  const auto ed = [&] { return ex + WG_ROWS * opaque(ldx); };  // formed where used
  float* const slab0 = wslabs + ((long)blockIdx.x * WARP_SLABS + wg * 4 + warp) * vstride;
  const VecAt o{W, H};
  float acc[128];
  uint32_t a[16][4];

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * WS_TILE + wg * WG_ROWS;
    named_sync(1 + wg, WG);  // the last tile's reads of ex / ed / raw / gs are done
    for (int i = tid; i < WG_ROWS * 4; i += WG) {
      const long e = 4L * p0 + i;
      gs[i] = e < 4L * n ? gout[e] : 0.f;  // rows past n: g = 0, so every delta is 0
    }
    // The thread's index opaque here, so that the encoding's index
    // arithmetic is formed per tile, not held in registers across it.
    encode_wg(pts, dirs, p0, n, d, KX, KD, ex, ldx, ed(), ldd, raw, 1 + wg, opaque(tid));
    named_sync(1 + wg, WG);
    stash_enc(ex, ldx, opaque(stash) + sp.act[0], KX, p0);
    stash_enc(ed(), ldd, opaque(stash) + sp.act[1], KD, p0);
    {  // b11 and ba: the sums of the unrounded g (lane q: channel q).
      float v = gs[row * 4 + q] + gs[(row + 8) * 4 + q];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) opaque(slab0)[q < 3 ? o.b11() + q : o.ba()] += v;
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0u;

    // ---- the forward: h1..h8 and feat to the stash, the masks of h1..h8.
    load_frags(a, ex, ldx, KX);
    product(acc, a, KX, W, true, ring);
    epilogue(acc, a, opaque(wvec), W, true);
    stash_frags(a, opaque(stash) + sp.act[2], W, p0);
    keep_mask(a, W, msk);
#pragma unroll 1
    for (int l = 1; l < 8; ++l) {  // h_{l+1} (bias l at wvec + l W)
      product(acc, a, W, W, true, ring);
      if (l == 5) {  // l6 on [xyz_enc | h5]: h5 with w6a, then enc_x with w6b
        load_frags(a, ex, ldx, KX);
        product(acc, a, KX, W, false, ring);
      }
      epilogue(acc, a, opaque(wvec) + l * W, W, true);
      stash_frags(a, opaque(stash) + sp.act[2] + l * sp.wstride, W, p0);
      keep_mask(a, W, msk + l * MASK_WORDS * WG);
    }
    // wa: round(d sigma) . h8
    head_grad(a, W, round_to<__nv_bfloat16>(gs[row * 4 + 3]),
              round_to<__nv_bfloat16>(gs[(row + 8) * 4 + 3]), opaque(slab0) + o.wa());
    // feat = l9(h8), cast without ReLU.
    product(acc, a, W, W, true, ring);
    epilogue(acc, a, opaque(wvec) + 8 * W, W, false);
    stash_frags(a, opaque(stash) + sp.act[10], W, p0);
    // h10 = l10 on [feat | dir_enc] (H wide): feat with w10a, enc_d with w10b.
    product(acc, a, W, H, true, ring);
    load_frags(a, ed(), ldd, KD);
    product(acc, a, KD, H, false, ring);
    epilogue(acc, a, opaque(wvec) + o.b10(), H, true);

    // ---- heads: w11 (round(g_rgb) . h10), then d h10 = (round(g_rgb)
    // w11^T) (h10 > 0) in fp32 into h10's accumulator layout.
    float g0[3], g8[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      g0[ch] = round_to<__nv_bfloat16>(gs[row * 4 + ch]);
      g8[ch] = round_to<__nv_bfloat16>(gs[(row + 8) * 4 + ch]);
      head_grad(a, H, g0[ch], g8[ch], opaque(slab0) + o.w11() + ch * H);
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (c * 16 < H) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c * 16 + 8 * h + 2 * q;
          float2 w[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            w[ch] = __ldg(
                reinterpret_cast<const float2*>(opaque(wvec) + o.w11() + ch * H + col));
          const uint32_t m0 = pos_bits(a[c][2 * h]), m8 = pos_bits(a[c][2 * h + 1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v0 = 0.f, v8 = 0.f;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              const float wc = e ? w[ch].y : w[ch].x;
              v0 = fmaf(wc, g0[ch], v0);
              v8 = fmaf(wc, g8[ch], v8);
            }
            acc[8 * c + 4 * h + e] = ((m0 >> e) & 1u) ? v0 : 0.f;
            acc[8 * c + 4 * h + 2 + e] = ((m8 >> e) & 1u) ? v8 : 0.f;
          }
        }
      }
    }
    delta_epilogue<false, false>(acc, a, H, nullptr, nullptr, 0.f, 0.f,
                                 opaque(stash) + sp.del[9], p0, opaque(slab0) + o.b10());

    // ---- the input gradients, each delta the A fragment of the next.
    // d feat = d h10 w10a (l9 has no ReLU).
    product(acc, a, H, W, true, ring);
    delta_epilogue<false, false>(acc, a, W, nullptr, nullptr, 0.f, 0.f,
                                 opaque(stash) + sp.del[8], p0, opaque(slab0) + 8 * W);
    // d h8 = (d feat w9 + wa d sigma) (h8 > 0).
    product(acc, a, W, W, true, ring);
    delta_epilogue<true, true>(acc, a, W, msk + 7 * MASK_WORDS * WG, opaque(wvec) + o.wa(),
                               round_to<__nv_bfloat16>(gs[row * 4 + 3]),
                               round_to<__nv_bfloat16>(gs[(row + 8) * 4 + 3]),
                               opaque(stash) + sp.del[7], p0, opaque(slab0) + 7 * W);
    // d h_{l+1} = (d h_{l+2} w_{l+2}) (h_{l+1} > 0), through w8, w7, w6a,
    // w5, w4, w3, w2.
#pragma unroll 1
    for (int l = 6; l >= 0; --l) {
      product(acc, a, W, W, true, ring);
      delta_epilogue<false, true>(acc, a, W, msk + l * MASK_WORDS * WG, nullptr, 0.f, 0.f,
                                  opaque(stash) + sp.del[0] + l * sp.wstride, p0,
                                  opaque(slab0) + l * W);
    }
  }
}

template <int FW, int FH, int FKX, int FKD>
__global__ void __launch_bounds__(WS_THREADS, 1)
fused_nerf_bwd_wgmma(const __grid_constant__ BwdMaps maps, const float* __restrict__ pts,
                     const float* __restrict__ dirs, const float* __restrict__ g,
                     const float* __restrict__ wvec, float* __restrict__ vslabs,
                     float* __restrict__ wslabs, long vstride,
                     __nv_bfloat16* __restrict__ stash, Stash sp, int n, Dims d, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  // Aligned to 1024 B by an offset into the shared array, so that shared
  // accesses stay 32-bit shared addressing.
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const Bf16Plan pl = bwd_plan(d);
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
      for (int m = 0; m < MATS; ++m) prefetch_tmap(&maps.fwd[m]);
      for (int j = 0; j < DGRAD; ++j) prefetch_tmap(&maps.dg[j]);
      const uint32_t dg_bytes = (uint32_t)wgmma_rows(d.W) * KCHUNK * 2;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int m = 0; m < MATS; ++m) {
          int K, N;
          mat_shape(m, d, &K, &N);
          for (int k0 = 0; k0 < K; k0 += KCHUNK)
            ring_load(ring, &maps.fwd[m], k0, (uint32_t)wgmma_rows(N) * KCHUNK * 2);
        }
        for (int j = 0; j < DGRAD; ++j)
          for (int k0 = 0; k0 < dgrad_k(j, d); k0 += KCHUNK)
            ring_load(ring, &maps.dg[j], k0, dg_bytes);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    bwd_consumer<FW, FH, FKX, FKD>(pts, dirs, g, wvec, wslabs, vstride, stash, sp, n, d, tiles,
                                   pl, smem, ring);
    // Every warp's slab is complete: the block's slab is their sum, in order.
    named_sync(BOTH, CONSUMERS * WG);
    const float* ws = opaque(wslabs) + (long)blockIdx.x * WARP_SLABS * vstride;
    float* block = opaque(vslabs) + (long)blockIdx.x * vstride;
    const int count = 10 * d.W + 4 * d.H + 8;  // Offsets::vec_total
    for (int e = threadIdx.x; e < count; e += CONSUMERS * WG) {
      float s = 0.f;
      for (int w = 0; w < WARP_SLABS; ++w) s += ws[w * vstride + e];
      block[e] = s;
    }
  }
}

// ------------------------------------------------------------ pass 1, fp32
// fused_nerf_bwd_ffma: nerf_ffma.cuh's block. Its own shared memory: the
// tile's g [64][4] (fp32) and the ReLU masks of h1..h8, [MASKED][2][256]
// (two 32-bit words a consumer thread a layer, word-major).
constexpr int MASK_WORDS32 = 2;  // 64 bits a thread: one per accumulator register
constexpr size_t G32_BYTES = ffma::TILE * 4 * sizeof(float);
constexpr size_t OWN32 = G32_BYTES + (size_t)MASKED * MASK_WORDS32 * ffma::CONSUMER_THREADS * 4;
constexpr int ROW_SLABS = 2;     // vector slabs a block: one per row of 4 consumer warps

__host__ __device__ inline ffma::Plan bwd32_plan(const Dims& d) { return ffma::plan(d, OWN32); }

// Keep the ReLU mask of v (N wide) in msk: bit 8 (i % 4) + j of word i / 4
// is v[i][j] > 0, in the thread's own slot of each word.
template <int NCH>
__device__ __forceinline__ void keep_mask32(const float (&v)[8][8], int N, uint32_t* msk,
                                            const ffma::Thr& t) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc)
    if (ffma::chunk_in(jc, N, t))
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          w[i >> 2] |= (uint32_t)(v[i][4 * jc + jj] > 0.f) << (8 * (i & 3) + 4 * jc + jj);
  msk[threadIdx.x] = w[0];
  msk[ffma::CONSUMER_THREADS + threadIdx.x] = w[1];
}

// v[i][j] <- v[i][j] where the mask msk (keep_mask32's layout) has its bit.
template <int NCH>
__device__ __forceinline__ void apply_mask32(float (&v)[8][8], const uint32_t* msk) {
  const uint32_t w[2] = {msk[threadIdx.x], msk[ffma::CONSUMER_THREADS + threadIdx.x]};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NCH; ++j)
      v[i][j] = ((w[i >> 2] >> (8 * (i & 3) + j)) & 1u) ? v[i][j] : 0.f;
}

// dst[col(j)] += the sum over the tile's points this warp row holds of
// val(i, j), for this thread's columns below N: the thread's 8 points in
// order, then the 4 threads of the warp that share the column group (a
// fixed shuffle tree); lanes 0-7 add it to the row's slab. Every lane
// calls it (the shuffles are the warp's).
template <int NCH, class Val>
__device__ __forceinline__ void col_sums32(float* dst, int N, const ffma::Thr& t,
                                           const Val& val) {
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc) {
    const bool in = ffma::chunk_in(jc, N, t);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float s = 0.f;
      if (in) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s += val(i, 4 * jc + jj);
      }
      s = ffma::col_sum4(s);
      if (in && t.lane < 8) dst[t.col(4 * jc + jj)] += s;
    }
  }
}

// Rows p0 + point(i) of a stash operand dst [rows, N] <- v, 16 bytes at a
// time (a warp's store: 4 rows of 128 contiguous bytes), streaming.
template <int NCH>
__device__ __forceinline__ void stash_regs(const float (&v)[8][8], float* dst, int N, int p0,
                                           const ffma::Thr& t) {
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc)
    if (ffma::chunk_in(jc, N, t))
#pragma unroll
      for (int i = 0; i < 8; ++i)
        __stcs(reinterpret_cast<float4*>(dst + (long)(p0 + t.point(i)) * N + t.col(4 * jc)),
               make_float4(v[i][4 * jc], v[i][4 * jc + 1], v[i][4 * jc + 2], v[i][4 * jc + 3]));
}

// The tile's encoding E [width][64] (swizzled) to rows p0.. of a stash
// operand [rows, width], 16 bytes at a time.
__device__ __forceinline__ void stash_enc32(const float* E, int width, float* dst, int p0) {
  const int vw = width / 4;
  for (int i = threadIdx.x; i < ffma::TILE * vw; i += ffma::CONSUMER_THREADS) {
    const int r = i / vw, c = (i % vw) * 4;
    __stcs(reinterpret_cast<float4*>(dst + (long)(p0 + r) * width + c),
           make_float4(E[ffma::swz(c, r)], E[ffma::swz(c + 1, r)], E[ffma::swz(c + 2, r)],
                       E[ffma::swz(c + 3, r)]));
  }
}

// The consumer warps' walk over their tiles: the forward, keeping what the
// chain and the weight gradients need, then the input gradients, each
// delta in registers, then over its input in the shared buffer as the next
// product's A. FW, FH, FKX, FKD fix the widths at compile time (0: read
// them from d; every product then takes both column chunks).
template <int FW, int FH, int FKX, int FKD>
__device__ __forceinline__ void bwd32_consumer(const float* __restrict__ pts,
                                               const float* __restrict__ dirs,
                                               const float* __restrict__ gout,
                                               const float* __restrict__ wvec,
                                               float* __restrict__ vslabs, long vstride,
                                               float* __restrict__ stash, const Stash& sp, int n,
                                               const Dims& d, int tiles, const ffma::Plan& pl,
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
  float* gs = reinterpret_cast<float*>(smem + pl.own_at);
  uint32_t* msk = reinterpret_cast<uint32_t*>(smem + pl.own_at + G32_BYTES);
  const Stages st{reinterpret_cast<const float*>(smem), (int)(pl.stage_bytes / 4)};
  float* const slab = vslabs + ((long)blockIdx.x * ROW_SLABS + (t.warp >> 2)) * vstride;
  const Offsets o = offsets(d);
  zero_pad_rows(d, ex, ed);
  float acc[8][8];
  const auto g = [&](int i, int ch) { return gs[t.point(i) * 4 + ch]; };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * TILE;
    named_sync(BAR, CONSUMER_THREADS);  // the last tile's reads of ex, ed, raw, gs, buf are done
    for (int i = threadIdx.x; i < TILE * 4; i += CONSUMER_THREADS) {
      const long e = 4L * p0 + i;
      gs[i] = e < 4L * n ? gout[e] : 0.f;  // rows past n: g = 0, so every delta is 0
    }
    encode(pts, dirs, p0, n, d, ex, ed, raw);  // ends with the consumers' barrier
    stash_enc32(ex, KX, stash + sp.act[0], p0);
    stash_enc32(ed, KD, stash + sp.act[1], p0);
    if (threadIdx.x < 4) {  // b11 and ba: the sums of g over the tile's points, in order
      float v = 0.f;
      for (int p = 0; p < TILE; ++p) v += gs[p * 4 + threadIdx.x];
      slab[threadIdx.x < 3 ? o.b11 + threadIdx.x : o.ba] += v;
    }

    // ---- the forward: h1..h8 and feat to the stash, the masks of h1..h8.
    ffma::product<NW>(acc, ex, KX, W, true, ring, st, t);
    bias_act<NW>(acc, wvec + o.b[0], W, true, t);
    stash_regs<NW>(acc, stash + sp.act[2], W, p0, t);
    keep_mask32<NW>(acc, W, msk, t);
    store_rows<NW>(acc, buf, W, t);
    named_sync(BAR, CONSUMER_THREADS);
#pragma unroll 1
    for (int l = 1; l < 9; ++l) {  // h_{l+1} (bias l at wvec + l W), l = 8: feat
      ffma::product<NW>(acc, buf, W, W, true, ring, st, t);
      if (l == 5) ffma::product<NW>(acc, ex, KX, W, false, ring, st, t);  // l6's enc_x part
      bias_act<NW>(acc, wvec + l * W, W, l < 8, t);
      stash_regs<NW>(acc, stash + sp.act[2] + l * sp.wstride, W, p0, t);
      if (l < 8) keep_mask32<NW>(acc, W, msk + l * MASK_WORDS32 * CONSUMER_THREADS, t);
      if (l == 7)  // wa: d sigma . h8
        col_sums32<NW>(slab + o.wa, W, t, [&](int i, int j) { return g(i, 3) * acc[i][j]; });
      named_sync(BAR, CONSUMER_THREADS);
      store_rows<NW>(acc, buf, W, t);
      named_sync(BAR, CONSUMER_THREADS);
    }
    // h10 = l10 on [feat | dir_enc] (H wide), in registers.
    ffma::product<NH>(acc, buf, W, H, true, ring, st, t);
    ffma::product<NH>(acc, ed, KD, H, false, ring, st, t);
    bias_act<NH>(acc, wvec + o.b10, H, true, t);

    // ---- heads: w11 (g_rgb . h10), then d h10 = (g_rgb w11^T) (h10 > 0).
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      col_sums32<NH>(slab + o.w11 + ch * H, H, t,
                     [&](int i, int j) { return g(i, ch) * acc[i][j]; });
#pragma unroll
    for (int jc = 0; jc < NH; ++jc) {
      if (chunk_in(jc, H, t)) {
        float4 w[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          w[ch] = __ldg(reinterpret_cast<const float4*>(wvec + o.w11 + ch * H + t.col(4 * jc)));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float g0 = g(i, 0), g1 = g(i, 1), g2 = g(i, 2);
          const float dv[4] = {fmaf(w[2].x, g2, fmaf(w[1].x, g1, w[0].x * g0)),
                               fmaf(w[2].y, g2, fmaf(w[1].y, g1, w[0].y * g0)),
                               fmaf(w[2].z, g2, fmaf(w[1].z, g1, w[0].z * g0)),
                               fmaf(w[2].w, g2, fmaf(w[1].w, g1, w[0].w * g0))};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][4 * jc + jj] = acc[i][4 * jc + jj] > 0.f ? dv[jj] : 0.f;
        }
      }
    }
    col_sums32<NH>(slab + o.b10, H, t, [&](int i, int j) { return acc[i][j]; });
    stash_regs<NH>(acc, stash + sp.del[9], H, p0, t);
    named_sync(BAR, CONSUMER_THREADS);  // every thread has read buf (feat)
    store_rows<NH>(acc, buf, H, t);
    named_sync(BAR, CONSUMER_THREADS);

    // ---- the input gradients. d feat = d h10 w10a^T (l9 has no ReLU).
    ffma::product<NW>(acc, buf, H, W, true, ring, st, t);
    col_sums32<NW>(slab + o.b[8], W, t, [&](int i, int j) { return acc[i][j]; });
    stash_regs<NW>(acc, stash + sp.del[8], W, p0, t);
    named_sync(BAR, CONSUMER_THREADS);
    store_rows<NW>(acc, buf, W, t);
    named_sync(BAR, CONSUMER_THREADS);
    // d h8 = (d feat w9^T + wa d sigma) (h8 > 0), then d h_{l+1} = (d h_{l+2}
    // w_{l+2}^T) (h_{l+1} > 0) through w8, w7, w6a, w5, w4, w3, w2.
#pragma unroll 1
    for (int l = 7; l >= 0; --l) {
      ffma::product<NW>(acc, buf, W, W, true, ring, st, t);
      if (l == 7) {
#pragma unroll
        for (int jc = 0; jc < NW; ++jc) {
          if (chunk_in(jc, W, t)) {
            const float4 w4 = __ldg(reinterpret_cast<const float4*>(wvec + o.wa + t.col(4 * jc)));
            const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                acc[i][4 * jc + jj] = fmaf(ww[jj], g(i, 3), acc[i][4 * jc + jj]);
          }
        }
      }
      apply_mask32<NW>(acc, msk + l * MASK_WORDS32 * CONSUMER_THREADS);
      col_sums32<NW>(slab + l * W, W, t, [&](int i, int j) { return acc[i][j]; });
      stash_regs<NW>(acc, stash + sp.del[0] + l * sp.wstride, W, p0, t);
      if (l > 0) {
        named_sync(BAR, CONSUMER_THREADS);
        store_rows<NW>(acc, buf, W, t);
        named_sync(BAR, CONSUMER_THREADS);
      }
    }
  }
}

template <int FW, int FH, int FKX, int FKD>
__global__ void __launch_bounds__(ffma::THREADS, 1)
fused_nerf_bwd_ffma(const float* __restrict__ pts, const float* __restrict__ dirs,
                    const float* __restrict__ g, const float* __restrict__ wmat,
                    const float* __restrict__ wt, const float* __restrict__ wvec,
                    float* __restrict__ vslabs, long vstride, float* __restrict__ stash,
                    Stash sp, int n, Dims d, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ffma::Plan pl = bwd32_plan(d);
  Ring ring = ffma::make_ring(smem, pl);
  __syncthreads();
  if (threadIdx.x >= ffma::CONSUMER_THREADS) {  // the producer warp: its lane 0 streams
    if (threadIdx.x == ffma::CONSUMER_THREADS) {
      const Offsets o = offsets(d);
      const long at[MATS] = {o.w1, o.w2, o.w3, o.w4, o.w5, o.w6a, o.w6b, o.w7, o.w8, o.w9,
                             o.w10a, o.w10b};
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int m = 0; m < MATS; ++m) {  // the forward's blocks [in, out]
          int K, N;
          mat_shape(m, d, &K, &N);
          ffma::stream_block(ring, wmat + at[m], K, N);
        }
        for (int j = 0; j < DGRAD; ++j)  // the input gradients' blocks [out, in]
          ffma::stream_block(ring, wt + dgrad_at(j, o), dgrad_k(j, d), d.W);
      }
    }
    return;
  }
  bwd32_consumer<FW, FH, FKX, FKD>(pts, dirs, g, wvec, vslabs, vstride, stash, sp, n, d, tiles,
                                   pl, smem, ring);
}

// ------------------------------------------------------------ pass 2
// The weight blocks in packed order, each G[out, in] = sum over points of
// delta[t, out] * input[t, in] (stored [out, in] in bf16, [in, out] in fp32,
// as the weights are packed).
struct Job {
  int del, act, M, N;   // stash operands; M outputs, N inputs
  long goff;            // offset of the block in the packed matrices
};
constexpr int JOBS = 12;

__host__ __device__ inline Job wgrad_job(int j, const Dims& d, const Offsets& o) {
  const int W = d.W;
  switch (j) {
    case 0: return {0, 0, W, d.KX, o.w1};
    case 1: return {1, 2, W, W, o.w2};
    case 2: return {2, 3, W, W, o.w3};
    case 3: return {3, 4, W, W, o.w4};
    case 4: return {4, 5, W, W, o.w5};
    case 5: return {5, 6, W, W, o.w6a};
    case 6: return {5, 0, W, d.KX, o.w6b};
    case 7: return {6, 7, W, W, o.w7};
    case 8: return {7, 8, W, W, o.w8};
    case 9: return {8, 9, W, W, o.w9};
    case 10: return {9, 10, d.H, W, o.w10a};
    default: return {9, 1, d.H, d.KD, o.w10b};
  }
}

__host__ __device__ inline int job_tiles(const Job& j, int mt, int nt) {
  return ((j.M + mt - 1) / mt) * ((j.N + nt - 1) / nt);
}

__host__ __device__ inline int wgrad_tiles(const Dims& d, int mt, int nt) {
  const Offsets o = offsets(d);
  int t = 0;
  for (int q = 0; q < JOBS; ++q) t += job_tiles(wgrad_job(q, d, o), mt, nt);
  return t;
}

// The weight block and output tile (m0, n0) of grid column b, for output
// tiles of mt x nt.
__device__ inline Job locate(int b, const Dims& d, int mt, int nt, int* m0, int* n0) {
  const Offsets o = offsets(d);
  Job j = wgrad_job(0, d, o);
  for (int q = 0; q < JOBS; ++q) {
    j = wgrad_job(q, d, o);
    if (b < job_tiles(j, mt, nt)) break;
    b -= job_tiles(j, mt, nt);
  }
  const int ntiles = (j.N + nt - 1) / nt;
  *m0 = (b / ntiles) * mt;
  *n0 = (b % ntiles) * nt;
  return j;
}

// bf16: wgmma, both operands read by TMA from the stash as it lies. A box
// [64 points, 64 columns] of an operand [rows, width] is MN-major for the
// product (A = D^T [out, points]: out contiguous; B = H [points, in]: in
// contiguous), which wgmma takes for 16-bit types through its transpose
// bits. A block holds an output tile of WM = 128 rows (out; 64 for each
// consumer warpgroup) by up to WN = 256 columns (in), so that a weight
// block reads its D once and its H once per 128 outputs (the two row tiles
// of a block run side by side and share H through L2), against 4 times
// each for 64 x 64 tiles. One TMA producer warpgroup fills a ring of
// W_STAGES stages of 64 points: A's two boxes, then B's boxes.
constexpr int WK = 64;             // points per stage
constexpr int WM = 128, WN = 256;  // output tile
constexpr int W_STAGES = 4;
constexpr int BOX = WK * 64 * 2;   // one TMA box [64 points, 64 columns] (8 KB)
constexpr int W_STAGE_BYTES = (WM / 64 + WN / 64) * BOX;

struct WgradMaps {
  CUtensorMap act[N_ACT], del[N_DEL];  // stash operands [chunk points, width]
};

inline int wgrad_smem() { return 1024 + W_STAGES * W_STAGE_BYTES + 2 * W_STAGES * 8; }

// acc[64, NBS x 64] += A[64 out, steps x 64 points] B[.., NBS x 64 in] over
// the next `steps` stages (this warpgroup's A box: wg), then the fp32
// partial of this warpgroup's rows to G [M, N] (rows past M, columns past
// N dropped).
template <int NBS>
__device__ __forceinline__ void wgrad_consume(Ring& r, int steps, const Job& j, int m0, int n0,
                                              float* __restrict__ G) {
  const int wg = threadIdx.x / WG, warp = (threadIdx.x % WG) / 32;
  const int lane = threadIdx.x % 32, q = lane % 4;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
  wgmma_fence();
  int prev = -1;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(r.full_bar(), r.phase);
    const uint32_t a = r.tile() + wg * BOX, b = r.tile() + (WM / 64) * BOX;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NBS; ++nb)
        wgmma_m64n64k16_ss_mn(&acc[nb * 32], desc_sw128_mn(a + kk * 2048),
                              desc_sw128_mn(b + nb * BOX + kk * 2048), 1);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(r.empty_bar(prev));
    }
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  if (prev >= 0 && lane == 0) mbar_arrive(r.empty_bar(prev));
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
#pragma unroll
  for (int nb = 0; nb < NBS; ++nb)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * hh;
        const int col = n0 + 64 * nb + 8 * jj + 2 * q;
        if (row < j.M && col < j.N)
          *reinterpret_cast<float2*>(G + (long)row * j.N + col) =
              make_float2(acc[nb * 32 + 4 * jj + 2 * hh], acc[nb * 32 + 4 * jj + 2 * hh + 1]);
      }
}

// Grid (tiles, splits): block (x, y) forms output tile x of G over the
// points [y kc, min(rows, (y + 1) kc)) of the chunk (kc a multiple of WK;
// TMA reads points past rows as zeros) into partial y.
__global__ void __launch_bounds__(WS_THREADS, 1)
wgrad_wgmma(const __grid_constant__ WgradMaps maps, Dims d, int rows, int kc,
            float* __restrict__ part, long pstride) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(smem), bars = base + W_STAGES * W_STAGE_BYTES;
  Ring ring{base, bars, bars + 8 * W_STAGES, W_STAGE_BYTES, W_STAGES, 0, 0};
  int m0, n0;
  const Job j = locate(blockIdx.x, d, WM, WN, &m0, &n0);
  const int k0 = blockIdx.y * kc;
  const int k1 = rows < k0 + kc ? rows : k0 + kc;
  const int steps = k1 > k0 ? (k1 - k0 + WK - 1) / WK : 0;
  const int nbs = ((j.N - n0 < WN ? j.N - n0 : WN) + 63) / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty_bar(s), CONSUMERS * WG / 32);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x / WG == CONSUMERS) {  // producer warpgroup
    if (threadIdx.x % WG == 0) {
      const CUtensorMap* A = &maps.del[j.del];
      const CUtensorMap* B = &maps.act[j.act];
      const uint32_t bytes = (uint32_t)(WM / 64 + nbs) * BOX;
      for (int s = 0; s < steps; ++s) {
        const int k = k0 + s * WK;
        mbar_wait(ring.empty_bar(ring.stage), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full_bar(), bytes);
        for (int mb = 0; mb < WM / 64; ++mb)
          tma_load_2d(ring.tile() + mb * BOX, A, ring.full_bar(), m0 + 64 * mb, k);
        for (int nb = 0; nb < nbs; ++nb)
          tma_load_2d(ring.tile() + (WM / 64 + nb) * BOX, B, ring.full_bar(), n0 + 64 * nb, k);
        ring.advance();
      }
    }
    return;
  }
  float* G = part + blockIdx.y * pstride + j.goff;
  switch (nbs) {
    case 1: wgrad_consume<1>(ring, steps, j, m0, n0, G); break;
    case 2: wgrad_consume<2>(ring, steps, j, m0, n0, G); break;
    case 3: wgrad_consume<3>(ring, steps, j, m0, n0, G); break;
    default: wgrad_consume<4>(ring, steps, j, m0, n0, G); break;
  }
}

// fp32: FFMA, never TF32 (wgrad_ffma). A block of 256 threads holds an
// output tile of WT x WT (out x in), each thread an 8 x 8 register
// micro-tile: outs 4 tm .. + 3 and 64 + 4 tm .., ins 4 tn .. and 64 + 4 tn ..
// (tm = 4 (warp / 2) + lane / 8, tn = 8 (warp % 2) + lane % 8), so that a
// point's step reads its D row piece and its H row piece by 16-byte loads
// (one shared-memory wavefront each for a warp's A and its B) for 64 FFMAs.
// The stash as it lies: both operands [points, width], so each stage is
// WKT points' contiguous row pieces of D (WT outs) and H (WT ins), loaded
// by cp.async (16 bytes a copy, zero-filled past the split's points or the
// block's columns) into a ring of W32_STAGES stages, W32_STAGES - 1 ahead
// of the products.
constexpr int WT = 128;        // output tile (outs x ins)
constexpr int WKT = 32;        // points a stage holds
constexpr int W32_STAGES = 3;
constexpr int W32_THREADS = 256;
constexpr int W32_PER_SM = 2;  // blocks an SM holds (registers and shared memory)
constexpr int W32_STAGE_FLOATS = 2 * WKT * WT;
constexpr int W32_SMEM = W32_STAGES * W32_STAGE_FLOATS * 4;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Grid (tiles, splits): block (x, y) forms output tile x of G over the
// points [y kc, min(rows, (y + 1) kc)) of the chunk into partial y.
__global__ void __launch_bounds__(W32_THREADS, W32_PER_SM)
wgrad_ffma(const float* __restrict__ stash, Stash sp, Dims d, int rows, int kc,
           float* __restrict__ part, long pstride) {
  extern __shared__ __align__(16) float wsm[];
  int m0, n0;
  const Job j = locate(blockIdx.x, d, WT, WT, &m0, &n0);
  const float* D = stash + sp.del[j.del];  // [rows, M]
  const float* Hm = stash + sp.act[j.act];  // [rows, N]
  const int k0 = blockIdx.y * kc;
  const int k1 = rows < k0 + kc ? rows : k0 + kc;
  const int steps = k1 > k0 ? (k1 - k0 + WKT - 1) / WKT : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = 4 * (warp >> 1) + (lane >> 3), tn = 8 * (warp & 1) + (lane & 7);
  // This thread's copies: column c of the stage's rows r0 + 8 q (q < 4) of
  // D's row pieces, then the same of H's ([2][WKT][WT] a stage).
  const int r0 = threadIdx.x / (WT / 4), c = 4 * (threadIdx.x % (WT / 4));
  const bool d_in = m0 + c < j.M, h_in = n0 + c < j.N;
  const float* dsrc = D + (d_in ? (long)(k0 + r0) * j.M + m0 + c : 0);
  const float* hsrc = Hm + (h_in ? (long)(k0 + r0) * j.N + n0 + c : 0);
  const long d_row8 = 8L * j.M, h_row8 = 8L * j.N;
  const uint32_t dst0 = smem_addr(wsm) + 4 * (r0 * WT + c);

  // Stage s <- the next WKT points (steps in order: the sources advance by
  // WKT rows a call), zero past the split's points or the block's columns.
  int pt = k0 + r0;
  const auto load = [&](int s) {
    const uint32_t dst = dst0 + 4 * s * W32_STAGE_FLOATS;
#pragma unroll
    for (int q = 0; q < WKT / 8; ++q) {
      const bool in = pt + 8 * q < k1;
      cp_async16(dst + 4 * 8 * q * WT, dsrc + (in && d_in ? q * d_row8 : 0), in && d_in);
      cp_async16(dst + 4 * (WKT + 8 * q) * WT, hsrc + (in && h_in ? q * h_row8 : 0),
                 in && h_in);
    }
    pt += WKT;
    if (d_in) dsrc += 4 * d_row8;
    if (h_in) hsrc += 4 * h_row8;
  };
#pragma unroll
  for (int s = 0; s < W32_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<W32_STAGES - 2>();
    __syncthreads();  // stage `step` landed for all; stage step - 1 is free
    const int next = step + W32_STAGES - 1;
    if (next < steps) load(next % W32_STAGES);
    cp_async_commit();
    const float* Ds = wsm + (step % W32_STAGES) * W32_STAGE_FLOATS + 4 * tm;
    const float* Hs = wsm + (step % W32_STAGES) * W32_STAGE_FLOATS + WKT * WT + 4 * tn;
#pragma unroll
    for (int k = 0; k < WKT; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(Ds + k * WT);
      const float4 a1 = *reinterpret_cast<const float4*>(Ds + k * WT + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(Hs + k * WT);
      const float4 b1 = *reinterpret_cast<const float4*>(Hs + k * WT + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
  }
  cp_async_wait<0>();
  // The fp32 partial G [N in][M out] (the fp32 packing): each in row, two
  // pieces of 4 outs.
  float* G = part + blockIdx.y * pstride + j.goff;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int in = n0 + 4 * tn + (jj & 3) + 64 * (jj >> 2);
    if (in < j.N) {
#pragma unroll
      for (int ic = 0; ic < 2; ++ic) {
        const int o0 = m0 + 64 * ic + 4 * tm;
        if (o0 < j.M)
          *reinterpret_cast<float4*>(G + (long)in * j.M + o0) =
              make_float4(acc[4 * ic][jj], acc[4 * ic + 1][jj], acc[4 * ic + 2][jj],
                          acc[4 * ic + 3][jj]);
      }
    }
  }
}

// ------------------------------------------------------------ pass 3
// out[e] = sum over slabs b, in order, of slabs[b * stride + e].
__global__ void reduce_slabs(const float* __restrict__ slabs, long stride, int count_slabs,
                             float* __restrict__ out, long count) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int b = 0; b < count_slabs; ++b) s += slabs[b * stride + e];
  out[e] = s;
}

// ------------------------------------------------------------ host side
inline long round_up_l(long x, long m) { return (x + m - 1) / m * m; }

inline int splits_for(int cn) {
  const int s = (cn + SPLIT_POINTS - 1) / SPLIT_POINTS;
  return s < 1 ? 1 : s > MAX_SPLITS ? MAX_SPLITS : s;
}

// fp32: wgrad_ffma's blocks (output tiles x splits) all do the same work,
// W32_PER_SM at a time on an SM, so a last wave that is mostly empty costs
// a whole wave. Take the least split count from splits_for(cn) up whose
// blocks fill at least 90% of their waves, keeping at least MIN_SPLIT32
// points a split and at most MAX_SPLITS32 splits (else splits_for(cn)).
constexpr int MIN_SPLIT32 = 1024;
constexpr int MAX_SPLITS32 = 32;

inline int splits32_for(int cn, const Dims& d, int sms) {
  const int s0 = splits_for(cn), tiles = wgrad_tiles(d, WT, WT), slots = W32_PER_SM * sms;
  const int top = cn / MIN_SPLIT32 < MAX_SPLITS32 ? cn / MIN_SPLIT32 : MAX_SPLITS32;
  for (int s = s0; s <= top; ++s) {
    const long blocks = (long)tiles * s, waves = (blocks + slots - 1) / slots;
    if (blocks * 10 >= waves * slots * 9) return s;
  }
  return s0;
}

// The lego net (trunk 256, head 128, L = 10 / 4: KX = 64, KD = 32) gets its
// widths at compile time; other widths read them at run time.
inline bool fixed_widths(const Dims& d) {
  return d.W == 256 && d.H == 128 && d.KX == 64 && d.KD == 32;
}

// Byte layout of the workspace, each part 256-byte aligned: the vector
// slabs (bf16: one per block; fp32: one per block and row of consumer
// warps), (bf16) the warps' vector slabs, the split-K partials of pass 2 and
// the stash of one chunk.
struct Workspace {
  long vstride, mstride, rows;
  int sms, blocks, vslabs, wslabs, parts;
  size_t wslab_at, part_at, stash_at, total;
};

// The workspace and pass 1's blocks for n points (blocks: one per SM, at
// most one per tile of the first chunk); returns a cudaError_t value.
int plan_workspace(int n, const Dims& d, bool bf16, Workspace* w) {
  const Offsets o = offsets(d);
  const int first = n < CHUNK_POINTS ? n : CHUNK_POINTS;
  const int tile = bf16 ? WS_TILE : ffma::TILE;
  const int tiles = (first + tile - 1) / tile;
  int sms;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  w->sms = sms;
  w->blocks = tiles < sms ? tiles : sms;
  w->vslabs = bf16 ? w->blocks : w->blocks * ROW_SLABS;
  w->wslabs = bf16 ? w->blocks * WARP_SLABS : 0;
  w->parts = 0;
  for (int p0 = 0; p0 < n; p0 += CHUNK_POINTS) {
    const int cn = n - p0 < CHUNK_POINTS ? n - p0 : CHUNK_POINTS;
    w->parts += bf16 ? splits_for(cn) : splits32_for(cn, d, sms);
  }
  w->rows = round_up_l(first, tile);
  w->vstride = round_up_l(o.vec_total, 64);
  w->mstride = round_up_l(o.mat_total, 64);
  size_t p = round_up_l((long)w->vslabs * w->vstride * 4, 256);
  w->wslab_at = p;
  p += round_up_l((long)w->wslabs * w->vstride * 4, 256);
  w->part_at = p;
  p += round_up_l((long)w->parts * w->mstride * 4, 256);
  w->stash_at = p;
  p += round_up_l(stash_plan(d, w->rows).total * (bf16 ? 2L : 4L), 256);
  w->total = p;
  return 0;
}

// Pass 2 of one chunk of cn points in s splits (its split-K partials from
// `part`).
int launch_wgrad(const float* stash, const Stash& sp, const Dims& d, int cn, int s, float* part,
                 long mstride, cudaStream_t stream) {
  const int err = (int)cudaFuncSetAttribute(wgrad_ffma,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, W32_SMEM);
  if (err != 0) return err;
  const int kc = (int)round_up_l((cn + s - 1) / s, WKT);
  wgrad_ffma<<<dim3(wgrad_tiles(d, WT, WT), s), W32_THREADS, W32_SMEM, stream>>>(
      stash, sp, d, cn, kc, part, mstride);
  return (int)cudaGetLastError();
}

int launch_wgrad(const __nv_bfloat16* stash, const Stash& sp, const Dims& d, int cn,
                 float* part, long mstride, cudaStream_t stream) {
  WgradMaps maps;
  int err;
  for (int a = 0; a < N_ACT; ++a)
    if ((err = make_tmap_sw128(&maps.act[a], stash + sp.act[a], 2, cn, act_width(a, d), WK,
                               64)) != 0)
      return err;
  for (int k = 0; k < N_DEL; ++k)
    if ((err = make_tmap_sw128(&maps.del[k], stash + sp.del[k], 2, cn, del_width(k, d), WK,
                               64)) != 0)
      return err;
  if ((err = (int)cudaFuncSetAttribute(wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       wgrad_smem())) != 0)
    return err;
  const int s = splits_for(cn);
  const int kc = (int)round_up_l((cn + s - 1) / s, WK);
  wgrad_wgmma<<<dim3(wgrad_tiles(d, WM, WN), s), WS_THREADS, wgrad_smem(), stream>>>(
      maps, d, cn, kc, part, mstride);
  return (int)cudaGetLastError();
}

int launch_sums(const Workspace& w, const float* vslabs, const float* part, float* out,
                const Dims& d, cudaStream_t stream) {
  const Offsets o = offsets(d);
  reduce_slabs<<<(unsigned)((o.mat_total + 255) / 256), 256, 0, stream>>>(
      part, w.mstride, w.parts, out, o.mat_total);
  reduce_slabs<<<(unsigned)((o.vec_total + 255) / 256), 256, 0, stream>>>(
      vslabs, w.vstride, w.vslabs, out + o.mat_total, o.vec_total);
  return (int)cudaGetLastError();
}

int launch_bf16(const float* pts, const float* dirs, const float* g, const void* wmat,
                const void* wt, const float* wvec, void* ws, size_t ws_bytes, float* out,
                int n, Dims d, cudaStream_t stream) {
  Workspace w;
  int err = plan_workspace(n, d, true, &w);
  if (err != 0) return err;
  if (ws_bytes < w.total) return (int)cudaErrorInvalidValue;
  const Bf16Plan pl = bwd_plan(d);
  if (pl.stages < 2) return (int)cudaErrorInvalidConfiguration;
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* vslabs = reinterpret_cast<float*>(base);
  float* wslabs = reinterpret_cast<float*>(base + w.wslab_at);
  float* part = reinterpret_cast<float*>(base + w.part_at);
  __nv_bfloat16* stash = reinterpret_cast<__nv_bfloat16*>(base + w.stash_at);
  const Stash sp = stash_plan(d, w.rows);
  const Offsets o = offsets(d);
  const long at[MATS] = {o.w1, o.w2, o.w3, o.w4, o.w5, o.w6a, o.w6b, o.w7, o.w8, o.w9,
                         o.w10a, o.w10b};
  BwdMaps maps;
  for (int m = 0; m < MATS; ++m) {  // [out = N, in = K]: the forward's
    int K, N;
    mat_shape(m, d, &K, &N);
    err = make_tmap_sw128(&maps.fwd[m], static_cast<const __nv_bfloat16*>(wmat) + at[m], 2, N,
                          K, wgmma_rows(N), KCHUNK);
    if (err != 0) return err;
  }
  for (int j = 0; j < DGRAD; ++j) {  // [in = W, out = K]
    err = make_tmap_sw128(&maps.dg[j], static_cast<const __nv_bfloat16*>(wt) + dgrad_at(j, o),
                          2, d.W, dgrad_k(j, d), wgmma_rows(d.W), KCHUNK);
    if (err != 0) return err;
  }
  const auto kernel = fixed_widths(d) ? fused_nerf_bwd_wgmma<256, 128, 64, 32>
                                    : fused_nerf_bwd_wgmma<0, 0, 0, 0>;
  if ((err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)pl.total)) != 0)
    return err;
  if ((err = (int)cudaMemsetAsync(wslabs, 0, (size_t)w.wslabs * w.vstride * 4, stream)) != 0)
    return err;
  int at_part = 0;  // partials written so far
  for (int p0 = 0; p0 < n; p0 += CHUNK_POINTS) {
    const int cn = n - p0 < CHUNK_POINTS ? n - p0 : CHUNK_POINTS;
    const int tiles = (cn + WS_TILE - 1) / WS_TILE;
    kernel<<<tiles < w.blocks ? tiles : w.blocks, WS_THREADS, pl.total, stream>>>(
        maps, pts + 3L * p0, dirs + 3L * p0, g + 4L * p0, wvec, vslabs, wslabs, w.vstride, stash,
        sp, cn, d, tiles);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    if ((err = launch_wgrad(stash, sp, d, cn, part + (long)at_part * w.mstride, w.mstride,
                            stream)) != 0)
      return err;
    at_part += splits_for(cn);
  }
  return launch_sums(w, vslabs, part, out, d, stream);
}

int launch_fp32(const float* pts, const float* dirs, const float* g, const void* wmat,
                const void* wt, const float* wvec, void* ws, size_t ws_bytes, float* out,
                int n, Dims d, cudaStream_t stream) {
  Workspace w;
  int err = plan_workspace(n, d, false, &w);
  if (err != 0) return err;
  if (ws_bytes < w.total) return (int)cudaErrorInvalidValue;
  const ffma::Plan pl = bwd32_plan(d);
  if (pl.stages < 3) return (int)cudaErrorInvalidConfiguration;
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* vslabs = reinterpret_cast<float*>(base);
  float* part = reinterpret_cast<float*>(base + w.part_at);
  float* stash = reinterpret_cast<float*>(base + w.stash_at);
  const Stash sp = stash_plan(d, w.rows);
  const auto kernel = fixed_widths(d) ? fused_nerf_bwd_ffma<256, 128, 64, 32>
                                      : fused_nerf_bwd_ffma<0, 0, 0, 0>;
  if ((err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)pl.total)) != 0)
    return err;
  if ((err = (int)cudaMemsetAsync(vslabs, 0, (size_t)w.vslabs * w.vstride * 4, stream)) != 0)
    return err;
  int at_part = 0;  // partials written so far
  for (int p0 = 0; p0 < n; p0 += CHUNK_POINTS) {
    const int cn = n - p0 < CHUNK_POINTS ? n - p0 : CHUNK_POINTS;
    const int tiles = (cn + ffma::TILE - 1) / ffma::TILE;
    kernel<<<tiles < w.blocks ? tiles : w.blocks, ffma::THREADS, pl.total, stream>>>(
        pts + 3L * p0, dirs + 3L * p0, g + 4L * p0, static_cast<const float*>(wmat),
        static_cast<const float*>(wt), wvec, vslabs, w.vstride, stash, sp, cn, d, tiles);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    const int s = splits32_for(cn, d, w.sms);
    if ((err = launch_wgrad(stash, sp, d, cn, s, part + (long)at_part * w.mstride, w.mstride,
                            stream)) != 0)
      return err;
    at_part += s;
  }
  return launch_sums(w, vslabs, part, out, d, stream);
}

}  // namespace

extern "C" {

// Bytes of device workspace the backward needs for n points on the current
// device; negative: -(CUDA error).
long cvnerf_fused_nerf_bwd_workspace(int n, int W, int H, int Lx, int Ld, int bf16) {
  if (n <= 0) return 0;
  Workspace w;
  const int err = plan_workspace(n, make_dims(W, H, Lx, Ld), bf16 != 0, &w);
  return err != 0 ? -(long)err : (long)w.total;
}

// The backward's launch for n points on the current device, so the host can
// check its own arithmetic (ops/fused_mlp_bwd.py::bwd_launch_plan, bf16 != 0;
// bwd32_launch_plan, fp32): plan[0..6] = pass 1's blocks, threads and
// dynamic shared-memory bytes, its weight stages, the stash's rows, the
// workspace bytes and the split-K partials over all chunks. Returns a
// cudaError_t value.
int cvnerf_fused_nerf_bwd_plan(int n, int W, int H, int Lx, int Ld, int bf16, long* plan) {
  const Dims d = make_dims(W, H, Lx, Ld);
  Workspace w;
  const int err = plan_workspace(n, d, bf16 != 0, &w);
  if (err != 0) return err;
  plan[0] = w.blocks;
  if (bf16) {
    const Bf16Plan pl = bwd_plan(d);
    plan[1] = WS_THREADS;
    plan[2] = (long)pl.total;
    plan[3] = pl.stages;
  } else {
    const ffma::Plan pl = bwd32_plan(d);
    plan[1] = ffma::THREADS;
    plan[2] = (long)pl.total;
    plan[3] = pl.stages;
  }
  plan[4] = w.rows;
  plan[5] = (long)w.total;
  plan[6] = w.parts;
  return 0;
}

// out[mat + vec] = packed fp32 gradients of the fused MLP at (pts, dirs)
// for upstream g[n, 4]. wt holds wmat's blocks transposed, at wmat's
// offsets: [in, out] in bf16, which the wgmma input gradients read as their
// K-major B operand (a TMA tensor per block: 16-byte aligned, rows of
// 16-byte multiples); [out, in] in fp32, which the FFMA input gradients
// stream in K-slabs of contiguous rows (16-byte aligned). ws holds
// ws_bytes >= cvnerf_fused_nerf_bwd_workspace bytes of device memory (no
// initial contents needed). Launches the passes on `stream` and returns a
// cudaError_t (0 on success); does not synchronise.
int cvnerf_fused_nerf_backward(const float* pts, const float* dirs, const float* g,
                               const void* wmat, const void* wt, const float* wvec,
                               void* ws, long ws_bytes, float* out, int n, int W, int H,
                               int Lx, int Ld, int bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bf16(pts, dirs, g, wmat, wt, wvec, ws, (size_t)ws_bytes, out, n, d, s);
  return launch_fp32(pts, dirs, g, wmat, wt, wvec, ws, (size_t)ws_bytes, out, n, d, s);
}

}  // extern "C"
