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
// order, the int32 -> fp32 casts are exact (|acc| <= 127 * 127 * 384 <
// 2^24), and every fp32 step rounds once as the plain version's does: the
// multiply and the add of acc * s + b are __fmul_rn / __fadd_rn (no
// contraction into an FMA), the encodings are quantized by a multiply with
// the stored inverse, pad columns (inverse 0) quantize to 0, and the
// rounding is half to even (as torch.round) by the 1.5 x 2^23 addition of
// round_clip, after a clamp to the integer bounds (which commutes with the
// rounding).
//
// Bound on this card: operations. 1,186,816 int8 operations per point (the
// float forward's multiply-adds) against 24 B in and 16 B out per point, so
// the tensor cores' 1,979 TOPS (dense int8) bound it long before the 3.35
// TB/s of device memory. Design (fused_nerf_int8_wgmma), the bf16 kernel's
// (fused_mlp.cu) with int8 operands:
//   * one persistent block per SM walks tiles of 128 points: one producer
//     warpgroup and two consumer warpgroups of 64 points each
//     (nerf_wgmma.cuh);
//   * the producer's one thread streams every packed int8 matrix, tile after
//     tile, by TMA (one tensor map of bytes per matrix, box [fan-out rounded
//     up to 64, 128 columns], 128-byte swizzle) through a ring of
//     shared-memory stages with full/empty mbarriers (hopper.cuh's ring
//     walk); both consumer warpgroups read each stage, so each weight byte
//     leaves L2 once per 128 points (0.58 MB a tile at full width: 21 chunks
//     of at most 32 KB, a 256-wide layer in 2);
//   * products are wgmma.mma_async m64n64k32 s8 x s8 -> s32 across the
//     fan-out, the staged chunk the K-major B operand, the accumulator of a
//     whole layer (up to 64 x 256 s32, 128 registers a thread) in
//     registers; the l6 and l10 concatenations are split products into one
//     accumulator; the lego widths are compile-time constants, other widths
//     run-time values;
//   * activations stay in registers: the requant epilogue runs on the
//     accumulator fragment and packs the int8 results straight into the next
//     layer's A fragment, so h1..h10 never touch shared memory. The two
//     layouts differ (a thread's accumulator columns of a 32-column block
//     are 8j + 2t + {0,1}, j < 4; its A bytes k = 4t + {0..3} and 16 + 4t +
//     {0..3}), so pack_qparams stores the output rows of every staged matrix
//     permuted within each 32-row block: accumulator column c computes
//     logical output f(c) = 16 (j >> 1) + 4t + 2 (j & 1) + e, and four
//     results pack into one register by byte permutes, with no shuffle. The
//     scales and biases are read at the logical f (two float4 loads), and
//     the next layer's fan-in keeps its logical order. Columns past the
//     fan-out enter the A fragment as 0; a fan-in tail of 16 meets TMA's
//     zero-filled B columns;
//   * the requant rounds without the conversion pipe: clamp to [lo, 127],
//     add 1.5 x 2^23 (the integer lands in the low mantissa byte), pack the
//     four low bytes (__byte_perm); in the ReLU layers the clamps run on
//     the FMA pipe, not the ALU pipe that limits the requant (round_relu);
//     its scales and biases, and the head weights, are read from a
//     per-block copy in shared memory;
//   * the two consumer warpgroups take turns issuing a layer's products,
//     each handing the turn over once its wgmmas are issued, so that one's
//     requant epilogue runs beside the other's products (without turns
//     both issue, wait and requantize at once);
//   * each warpgroup encodes its 64 points from raw inputs staged by
//     coalesced loads (nerf_wgmma.cuh encode_staged; accurate sinf/cosf) and
//     writes the int8 encodings into a small padded shared buffer, which l1,
//     l6b and l10b read as A fragments with 32-bit loads;
//   * sigma and rgb are exact int32 dot products of the thread's A fragment
//     bytes of h8 / h10 with the head weights (__dp4a, logical order), summed
//     over the 4 threads of a row by __shfl_xor_sync, then dequantized once;
//     rows past n compute on the encoded origin and are never written;
//   * setmaxnreg gives the consumers 240 registers and the producer 24; the
//     shared-memory base is aligned by an offset into the shared array, so
//     every shared access is 32-bit LDS/STS (aligned through an integer
//     cast, the pointers became generic and 64-bit and spilled); no atomics
//     and a fixed tile -> block map: two launches on the same inputs are
//     bitwise equal.
// Where the time goes: scripts/int8_cost_probe.py.
// What the TPU kernel did for its matrix unit (the transposed [channels, T]
// layout, the mantissa-split phase matmul, 32-row int8 padding) has no
// counterpart here.
//
// Operand layout (packed by cvnerf_torch/ops/fused_mlp_int8.py::pack_qparams;
// every block starts 16-byte aligned and its rows are 16-byte multiples):
//   qmat (int8), each [out, in] row-major: w1 [W,KX], w2..w5 [W,W],
//     w6a [W,W] (hidden part), w6b [W,KX] (encoding part), w7, w8, w9 [W,W],
//     w10a [H,W] (feature part), w10b [H,KD] (dir-encoding part), with the
//     rows of these twelve in the order f above; wa [1,W], w11 [3,H] in
//     logical order; pad columns zero.
//   qvec (fp32, logical order): inv_x [KX], inv_d [KD] (zero at the pad
//     entries), then s1, b1, ..., s9, b9 [W] each, s10, b10 [H], sa [4],
//     ba [4], s11 [4], b11 [4] (the head vectors zero-padded to 4).

#include "nerf_wgmma.cuh"

namespace {

using namespace cvnerf;
using namespace hopper;

constexpr int KCHUNK = 128;      // k columns (bytes) a stage holds: one 128 B row
constexpr int KSTEP = 32;        // k of one wgmma (m64n64k32)
constexpr int MAX_STAGES = 8;
constexpr int ENC_PAD = 16;      // int8 encoding row padding (bytes; bank spread)
constexpr int NB = WGMMA_N;      // columns of one wgmma
constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 x 2^23
constexpr int BOTH = 3;  // named barrier of both consumer warpgroups (1, 2: each one's)
// The consumer warpgroups take turns issuing a layer's products (named
// barriers TURN + wg), each handing the turn over once its wgmmas are
// issued, so that one's requant epilogue runs beside the other's products.
constexpr int TURN = 4;

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

// Shared-memory plan (bytes from a 1024-aligned base; `total` includes the
// alignment slack): the weight stages [S][wgmma_rows(W) x 128 B], then each
// consumer warpgroup's int8 encodings qx [64, ldx] and qd [64, ldd] (the
// fan-ins rounded up to whole k32 steps, + 16 B), raw inputs [2][64 x 3]
// (fp32) and a copy of the head weights wa, w11 (W + 3H bytes), then the
// block's copy of qvec up to b10 (inv_x, inv_d, s1, b1, ..., s10, b10;
// fp32), then S full and S empty mbarriers. As many stages as fit, at most
// MAX_STAGES.
struct Int8Plan {
  int stages, ldx, ldd, heads;
  size_t stage_bytes, wg_bytes, vec_bytes, enc_at, vec_at, bars_at, total;
};

__host__ __device__ inline Int8Plan int8_plan(const Dims& d) {
  Int8Plan p;
  p.ldx = round_up(d.KX, KSTEP) + ENC_PAD;
  p.ldd = round_up(d.KD, KSTEP) + ENC_PAD;
  p.heads = d.W + 3 * d.H;  // a multiple of 16
  p.stage_bytes = (size_t)wgmma_rows(d.W) * KCHUNK;
  p.wg_bytes = (size_t)WG_ROWS * (p.ldx + p.ldd) + RAW_BYTES + p.heads;
  p.vec_bytes = (size_t)(d.KX + d.KD + 18 * d.W + 2 * d.H) * 4;
  const size_t enc = CONSUMERS * p.wg_bytes;
  const size_t room = SMEM_LIMIT - 1024 - enc - p.vec_bytes - 2 * MAX_STAGES * 8;
  p.stages = (int)(room / p.stage_bytes);
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  p.enc_at = p.stages * p.stage_bytes;
  p.vec_at = p.enc_at + enc;
  p.bars_at = p.vec_at + p.vec_bytes;
  p.total = 1024 + p.bars_at + 2 * p.stages * 8;
  return p;
}

// clip(rint(v), lo, 127) in the low byte of the result, for an integer lo:
// the clamp commutes with rint (monotonic, integer bounds), and adding
// 1.5 x 2^23 rounds to an integer, half to even as rintf, whose two's
// complement sits in the sum's low mantissa bits.
__device__ __forceinline__ uint32_t round_clip(float v, float lo) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, lo), 127.f), ROUND_MAGIC));
}

// The low bytes of four values as one int8x4 register, x0 lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3) {
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040), 0x5410);
}

// acc * s + b in fp32, each step rounded once (never an FMA).
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// clip(rint(v), 0, 128) in the low byte, its clamps on the FMA pipe (the
// ALU pipe, where fminf/fmaxf and the byte permutes run, limits the
// requant): v 2^-7 (exact) saturated to [0, 1], then times 128 plus
// 1.5 x 2^23 in one rounding (the product is exact).
__device__ __forceinline__ uint32_t round_relu(float v) {
  float w;
  asm("mul.rn.sat.f32 %0, %1, %2;" : "=f"(w) : "f"(v), "f"(0.0078125f));
  return __float_as_uint(__fmaf_rn(w, 128.f, ROUND_MAGIC));
}

// clip(rint(acc * s + b), lo, 127) of four accumulators as one int8x4
// register, the first lowest. With lo = 0 (the ReLU layers) by round_relu,
// whose one value past 127, 128 (0x80), is taken back to 127 on the packed
// register.
__device__ __forceinline__ uint32_t requant4(int a0, int a1, int a2, int a3, float4 s, float4 b,
                                             float lo) {
  if (lo == 0.f) {
    const uint32_t x = pack4(round_relu(dequant(a0, s.x, b.x)), round_relu(dequant(a1, s.y, b.y)),
                             round_relu(dequant(a2, s.z, b.z)), round_relu(dequant(a3, s.w, b.w)));
    return x - ((x >> 7) & 0x01010101u);
  }
  return pack4(round_clip(dequant(a0, s.x, b.x), lo), round_clip(dequant(a1, s.y, b.y), lo),
               round_clip(dequant(a2, s.z, b.z), lo), round_clip(dequant(a3, s.w, b.w), lo));
}

__device__ __forceinline__ uint32_t lds_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[64, N] (+)= A[64, K] W^T for the next ceil(K/128) staged chunks of
// packed matrix W [N, K]; A is this warpgroup's register fragment a[kb]
// (kb < K/32, rounded up). first: the product overwrites acc (else adds).
// issued() runs once every wgmma is issued, before they are waited for.
template <class Issued = NoHook>
__device__ __forceinline__ void product(int (&acc)[128], uint32_t (&a)[8][4], int K, int N,
                                        bool first, Ring& r, const Issued& issued = Issued()) {
  // Every write of acc and a happens before the fence, in program order.
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_operand(a[i][j]);
  wgmma_fence();
  ring_consume<256 / KCHUNK>(r, (K + KCHUNK - 1) / KCHUNK, [&](int kc, uint64_t desc) {
#pragma unroll
    for (int kk = 0; kk < KCHUNK / KSTEP; ++kk) {
      const int kb = kc * (KCHUNK / KSTEP) + kk;
      if (kb * KSTEP < K) {
        const int scale_d = (first && kb == 0) ? 0 : 1;
#pragma unroll
        for (int nb = 0; nb < 256 / NB; ++nb) {
          // B rows nb*NB..: 8-row atoms of 1024 B, i.e. 64 descriptor
          // units each; the k32 step: 32 B, i.e. 2.
          if (nb * NB < N)
            wgmma_m64n64k32_s8_rs(&acc[nb * NB / 2], a[kb], desc + 2 * kk + nb * NB * 8, scale_d);
        }
      }
    }
  }, issued);
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
}

// a[kb] <- A fragments of this warp's rows of E [64, ld] (int8, shared),
// k < K rounded up to 32: a[kb] = {(r, k0..k0+3), (r+8, k0..), (r, k0+16..),
// (r+8, k0+16..)} with r = 16 warp + lane/4 and k0 = 32 kb + 4 (lane%4).
__device__ __forceinline__ void load_frags(uint32_t (&a)[8][4], const uint8_t* E, int ld, int K) {
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const uint8_t* r0 = E + (warp * 16 + lane / 4) * ld + 4 * (lane % 4);
  const uint8_t* r8 = r0 + 8 * ld;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    if (kb * KSTEP < K) {
      a[kb][0] = lds_u32(r0 + kb * KSTEP);
      a[kb][1] = lds_u32(r8 + kb * KSTEP);
      a[kb][2] = lds_u32(r0 + kb * KSTEP + 16);
      a[kb][3] = lds_u32(r8 + kb * KSTEP + 16);
    }
  }
}

// a <- clip(rint(acc * s + b), lo, 127) over N columns, as the next layer's
// A fragment. In 32-column block cb the thread's accumulators
// acc[16 cb + 4 j + i] (row r + 8 (i >> 1), column 8 j + 2 t + (i & 1))
// hold the logical outputs 4t + {0..3} (j < 2) and 16 + 4t + {0..3} (j >= 2)
// of pack_qparams' row order, so byte k of a[cb] is logical column k.
// Columns past N enter as 0 (their s and b lie outside the vectors). s and
// b are in shared memory.
__device__ __forceinline__ void epilogue(const int (&acc)[128], uint32_t (&a)[8][4],
                                         const float* s, const float* b, int N, float lo) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int cb = 0; cb < 8; ++cb) {
    if (cb * 32 < N) {
      const auto c = [&](int k) { return acc[16 * cb + k]; };
      const float4 s0 = *reinterpret_cast<const float4*>(s + 32 * cb + 4 * t);
      const float4 b0 = *reinterpret_cast<const float4*>(b + 32 * cb + 4 * t);
      a[cb][0] = requant4(c(0), c(1), c(4), c(5), s0, b0, lo);
      a[cb][1] = requant4(c(2), c(3), c(6), c(7), s0, b0, lo);
      if (cb * 32 + 16 < N) {
        const float4 s1 = *reinterpret_cast<const float4*>(s + 32 * cb + 16 + 4 * t);
        const float4 b1 = *reinterpret_cast<const float4*>(b + 32 * cb + 16 + 4 * t);
        a[cb][2] = requant4(c(8), c(9), c(12), c(13), s1, b1, lo);
        a[cb][3] = requant4(c(10), c(11), c(14), c(15), s1, b1, lo);
      } else {
        a[cb][2] = a[cb][3] = 0u;
      }
    }
  }
}

// The exact int32 dots of this thread's two rows (r, r + 8) of the
// activation in `a` (N wide) with the int8 weights w [N] (logical order, in
// shared memory), summed over the row's 4 threads.
__device__ __forceinline__ int2 head_dot(const uint32_t (&a)[8][4], const uint8_t* w, int N) {
  const int t = threadIdx.x % 4;
  int d0 = 0, d8 = 0;
#pragma unroll
  for (int cb = 0; cb < 8; ++cb) {
    if (cb * 32 < N) {
      const int w0 = (int)lds_u32(w + 32 * cb + 4 * t);
      d0 = __dp4a((int)a[cb][0], w0, d0);
      d8 = __dp4a((int)a[cb][1], w0, d8);
      if (cb * 32 + 16 < N) {
        const int w1 = (int)lds_u32(w + 32 * cb + 16 + 4 * t);
        d0 = __dp4a((int)a[cb][2], w1, d0);
        d8 = __dp4a((int)a[cb][3], w1, d8);
      }
    }
  }
  return make_int2(quad_sum(d0), quad_sum(d8));
}

// The consumer warpgroups' walk over their tiles. FW, FH, FKX, FKD fix the
// widths at compile time (0: read them from d), so that every wgmma of a
// product is issued unconditionally.
template <int FW, int FH, int FKX, int FKD>
__device__ __forceinline__ void consumer(const float* __restrict__ pts,
                                         const float* __restrict__ dirs,
                                         const int8_t* __restrict__ qmat,
                                         const float* __restrict__ qvec, float* __restrict__ out,
                                         int n, const Dims& d, int tiles, const Int8Plan& pl,
                                         unsigned char* smem, Ring& ring) {
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int lane = threadIdx.x % 32;
  const int row = (tid / 32) * 16 + lane / 4;  // this thread's rows: row, row + 8
  uint8_t* qx = smem + pl.enc_at + wg * pl.wg_bytes;
  uint8_t* qd = qx + WG_ROWS * pl.ldx;
  float* raw = reinterpret_cast<float*>(qd + WG_ROWS * pl.ldd);
  uint8_t* heads = qd + WG_ROWS * pl.ldd + RAW_BYTES;  // wa [W], w11 [3, H]
  const int W = FW ? FW : d.W, H = FH ? FH : d.H;
  const int KX = FKX ? FKX : d.KX, KD = FKD ? FKD : d.KD;
  // Offsets from the widths as the instantiation knows them: constants at
  // the lego widths, so they hold no registers.
  const QOffsets o = qoffsets(Dims{W, H, KX, KD, d.Lx, d.Ld});
  // The pad columns (from the last real one to the last k32 step, all in
  // the last 32) stay zero: the encoding writes only the real ones.
  const int kxr = round_up(KX, KSTEP), kdr = round_up(KD, KSTEP);
  for (int i = tid; i < WG_ROWS * KSTEP; i += WG) {
    const int r = i / KSTEP, c = i % KSTEP;
    if (kxr - KSTEP + c >= 3 + 6 * d.Lx) qx[r * pl.ldx + kxr - KSTEP + c] = 0;
    if (kdr - KSTEP + c >= 3 + 6 * d.Ld) qd[r * pl.ldd + kdr - KSTEP + c] = 0;
  }
  // The head weights (contiguous in qmat), and the encodings' inverses and
  // the requants' scales and biases (qvec up to b10), in shared memory:
  // read from global memory in the loop, the compiler hoisted their
  // addresses (64-bit, ~40 a thread) out of it into registers that spilled.
  for (int i = tid; i < pl.heads / 4; i += WG)
    reinterpret_cast<uint32_t*>(heads)[i] = __ldg(reinterpret_cast<const uint32_t*>(qmat + o.wa) + i);
  float* vec = reinterpret_cast<float*>(smem + pl.vec_at);  // qvec's offsets o
  for (int i = wg * WG + tid; i < (int)pl.vec_bytes / 16; i += CONSUMERS * WG)
    reinterpret_cast<float4*>(vec)[i] = __ldg(reinterpret_cast<const float4*>(qvec) + i);
  named_sync(BOTH, CONSUMERS * WG);
  const auto emit = [&](bool dir, int r, int col, float v) {
    const float inv = vec[(dir ? o.inv_d : o.inv_x) + col];
    (dir ? qd + r * pl.ldd : qx + r * pl.ldx)[col] = (uint8_t)round_clip(__fmul_rn(v, inv), -127.f);
  };
  int acc[128];
  uint32_t a[8][4];
  const auto turn = [&] { named_sync(TURN + wg, CONSUMERS * WG); };
  const auto hand_over = [&] { named_arrive(TURN + 1 - wg, CONSUMERS * WG); };
  if (wg == 1) hand_over();  // warpgroup 0 takes the first turn

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * WS_TILE + wg * WG_ROWS;
    named_sync(1 + wg, WG);  // the last tile's reads of qx / qd / raw are done
    encode_staged(pts, dirs, p0, n, d, raw, 1 + wg, tid, emit);
    named_sync(1 + wg, WG);
    // Define acc and a afresh (the wgmmas read both as operands), so that
    // the last tile's values are dead while the encoding runs.
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0u;

    // l1: q_ex
    load_frags(a, qx, pl.ldx, KX);
    turn();
    product(acc, a, KX, W, true, ring, hand_over);
    epilogue(acc, a, vec + o.s[0], vec + o.b[0], W, 0.f);
    // l2..l5 (s_{l+1} 2 l W past s1, b_{l+1} W further)
#pragma unroll 1
    for (int l = 1; l < 5; ++l) {
      turn();
      product(acc, a, W, W, true, ring, hand_over);
      epilogue(acc, a, vec + o.s[0] + 2 * l * W, vec + o.s[0] + (2 * l + 1) * W, W, 0.f);
    }
    // l6 on [xyz_enc | h5]: h5 with w6a, then q_ex with w6b, one accumulator.
    turn();
    product(acc, a, W, W, true, ring);
    load_frags(a, qx, pl.ldx, KX);
    product(acc, a, KX, W, false, ring, hand_over);
    epilogue(acc, a, vec + o.s[5], vec + o.b[5], W, 0.f);
    // l7, l8
#pragma unroll 1
    for (int l = 6; l < 8; ++l) {
      turn();
      product(acc, a, W, W, true, ring, hand_over);
      epilogue(acc, a, vec + o.s[0] + 2 * l * W, vec + o.s[0] + (2 * l + 1) * W, W, 0.f);
    }
    // sigma = dequant(h8 . wa), fp32.
    const int2 sg = head_dot(a, heads, W);
    const float sa = __ldg(qvec + o.sa), ba = __ldg(qvec + o.ba);
    const float s0 = dequant(sg.x, sa, ba), s8 = dequant(sg.y, sa, ba);
    // feat = l9(h8), signed (no ReLU).
    turn();
    product(acc, a, W, W, true, ring, hand_over);
    epilogue(acc, a, vec + o.s[8], vec + o.b[8], W, -127.f);
    // l10 on [feat | dir_enc] (H wide): feat with w10a, q_ed with w10b.
    turn();
    product(acc, a, W, H, true, ring);
    load_frags(a, qd, pl.ldd, KD);
    product(acc, a, KD, H, false, ring, hand_over);
    epilogue(acc, a, vec + o.s10, vec + o.b10, H, 0.f);
    // rgb = dequant(h10 . w11[c]), fp32.
    float c0[3], c8[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int2 cd = head_dot(a, heads + W + ch * H, H);
      const float s = __ldg(qvec + o.s11 + ch), b = __ldg(qvec + o.b11 + ch);
      c0[ch] = dequant(cd.x, s, b);
      c8[ch] = dequant(cd.y, s, b);
    }
    if (lane % 4 == 0) {
      const int pa = p0 + row, pb = pa + 8;
      if (pa < n) reinterpret_cast<float4*>(out)[pa] = make_float4(c0[0], c0[1], c0[2], s0);
      if (pb < n) reinterpret_cast<float4*>(out)[pb] = make_float4(c8[0], c8[1], c8[2], s8);
    }
  }
  if (wg == 0) turn();  // meets warpgroup 1's last hand-over
}

template <int FW, int FH, int FKX, int FKD>
__global__ void __launch_bounds__(WS_THREADS, 1)
fused_nerf_int8_wgmma(const __grid_constant__ Maps maps, const float* __restrict__ pts,
                      const float* __restrict__ dirs, const int8_t* __restrict__ qmat,
                      const float* __restrict__ qvec, float* __restrict__ out, int n, Dims d,
                      int tiles) {
  extern __shared__ unsigned char smem_raw[];
  // The 1024-byte aligned base as an offset into the shared array, so that
  // every pointer derived from it stays in the shared space (32-bit
  // addresses, LDS/STS); through an integer cast they would be generic.
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const Int8Plan pl = int8_plan(d);
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
            ring_load(ring, &maps.m[m], k0, (uint32_t)wgmma_rows(N) * KCHUNK);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    consumer<FW, FH, FKX, FKD>(pts, dirs, qmat, qvec, out, n, d, tiles, pl, smem, ring);
  }
}

template <int FW = 0, int FH = 0, int FKX = 0, int FKD = 0>
int launch_int8(const float* pts, const float* dirs, const int8_t* qmat, const float* qvec,
                float* out, int n, Dims d, cudaStream_t stream) {
  const Int8Plan pl = int8_plan(d);
  if (pl.stages < 2) return (int)cudaErrorInvalidConfiguration;
  const QOffsets o = qoffsets(d);
  const long at[MATS] = {o.w1, o.w2, o.w3, o.w4, o.w5, o.w6a, o.w6b, o.w7, o.w8, o.w9,
                         o.w10a, o.w10b};
  Maps maps;
  for (int m = 0; m < MATS; ++m) {
    int K, N;
    mat_shape(m, d, &K, &N);
    const int err = make_tmap_sw128(&maps.m[m], qmat + at[m], 1, N, K, wgmma_rows(N), KCHUNK);
    if (err != 0) return err;
  }
  int sms;
  int err = sm_count(&sms);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(fused_nerf_int8_wgmma<FW, FH, FKX, FKD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.total);
  if (err != 0) return err;
  const int tiles = (n + WS_TILE - 1) / WS_TILE;
  fused_nerf_int8_wgmma<FW, FH, FKX, FKD><<<ws_grid(n, sms), WS_THREADS, pl.total, stream>>>(
      maps, pts, dirs, qmat, qvec, out, n, d, tiles);
  return (int)cudaGetLastError();
}

// The lego net (trunk 256, head 128, L = 10 / 4: KX = 64, KD = 32) gets its
// widths at compile time; other widths read them at run time.
inline bool int8_fixed(const Dims& d) {
  return d.W == 256 && d.H == 128 && d.KX == 64 && d.KD == 32;
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

// The launch for n points on the current device, so the host can check its
// own arithmetic (ops/fused_mlp_int8.py::int8_launch_plan): plan[0..4] =
// blocks, threads, dynamic shared-memory bytes, weight stages, widths fixed
// at compile time (1) or not (0). Returns a cudaError_t value.
int cvnerf_fused_nerf_int8_plan(int n, int W, int H, int Lx, int Ld, int* plan) {
  const Dims d = make_dims(W, H, Lx, Ld);
  const Int8Plan pl = int8_plan(d);
  int sms;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  plan[0] = ws_grid(n, sms);
  plan[1] = WS_THREADS;
  plan[2] = (int)pl.total;
  plan[3] = pl.stages;
  plan[4] = int8_fixed(d) ? 1 : 0;
  return 0;
}

// out[n, 4] = fused encode -> int8 MLP of (pts[n, 3], dirs[n, 3]). Launches
// on `stream` and returns cudaGetLastError() of the launch (0 on success);
// does not synchronise.
int cvnerf_fused_nerf_int8_forward(const float* pts, const float* dirs, const void* qmat,
                                   const float* qvec, float* out, int n, int W, int H, int Lx,
                                   int Ld, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  const int8_t* q = static_cast<const int8_t*>(qmat);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_fixed(d)) return launch_int8<256, 128, 64, 32>(pts, dirs, q, qvec, out, n, d, s);
  return launch_int8<>(pts, dirs, q, qvec, out, n, d, s);
}

}  // extern "C"
