// The Instant-NGP field's two 64-wide MLPs on the card (sm_90a): the
// density MLP 32 -> 64 -> 16 and the colour MLP 32 -> 64 -> 64 -> 3, no
// biases, as one forward kernel and one backward kernel whose weight
// gradients a third kernel sums over the blocks in a fixed order.
//
// It replaces no TPU kernel: the JAX package has no hash-grid field. It was
// added for the port's Instant-NGP field (models/ngp_field.py), whose MLPs
// ran as five torch.matmul's a pass with their casts, ReLUs, concatenations
// and autograd's glue, each reading and writing [n, 32..64] activations in
// device memory.
//
// What bounds it on this card: bytes and launches, not the tensor cores. A
// sample is 9,408 multiply-adds forward (14.4 us of bf16 tensor-core time for
// a train step's 2^18 samples, both passes); it reads 64 B of features and
// writes 16 B forward, reads the features and 16 B of gradient and writes
// 128 B of feature gradient backward (~76 MB a step, ~23 us at 3.35 TB/s).
//
// The design follows tiny-cuda-nn's fully fused MLP: activations stay in
// registers. Each block rounds the five float32 weight leaves to bf16 into
// shared memory at its start (no packing launch). A warp takes 16-sample row
// tiles through mma.sync.m16n8k16 (bf16 operands, fp32 sums); each layer's
// accumulator fragments are re-packed in registers as the next layer's A
// fragments, since a 16 x 16 slice of the m16n8 accumulators of two
// neighbouring n-tiles is laid out as an A fragment. The grid is persistent
// over the tiles and masks the ragged tail (a masked row reads zeros: with
// no biases every activation and delta of it is 0).
//
// Rounding points, as the torch.matmul chain had them: operands bf16;
// each hidden layer's fp32 sum rounded to bf16 after its ReLU; the two
// output layers (density l1, colour l2) return fp32 sums; geo and the SH
// rounded to bf16 as colour l0's input; sigma = expf(geo[0]).
//
// Backward: a block takes chunks of 128 samples (8 warps x 16). Each warp
// recomputes its tile's forward from the same inputs (bitwise the forward
// kernel's), then carries the deltas back: the two output layers' upstream
// gradients stay float32 and meet their bf16-valued weights in FFMA; the
// hidden deltas are bf16 operands of mma.sync with fp32 sums. The feature
// gradient is written in float32. Each layer's input and delta are staged
// in shared memory, and after a barrier the warps form the chunk's weight
// gradients X^T delta: three layers by mma.sync over the chunk's samples
// (ldmatrix.trans makes the transposed fragments), the two output layers by
// FFMA on float32 deltas, each output owned by one thread, summed over the
// block's chunks in registers. A block writes one slab of the 9,408 sums;
// ngp_mlp_wgrad_reduce adds the slabs in block order, so the weight
// gradients are the same bits from run to run. Nothing is allocated and
// nothing synchronises with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 32;    // hash features: 16 levels x 2
constexpr int kHid = 64;   // hidden width of both MLPs
constexpr int kGeo = 16;   // density outputs; output 0 is the log-density
constexpr int kSh = 16;    // degree-4 SH
constexpr int kRgb = 3;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16 * kWarps;  // samples of a backward chunk

// The leaves in the order the wrapper passes them, and their offsets in a
// slab (each [in][out] row-major, as the leaves).
constexpr int kOffD0 = 0;                      // density l0 [32][64]
constexpr int kOffD1 = kOffD0 + kIn * kHid;    // density l1 [64][16]
constexpr int kOffC0 = kOffD1 + kHid * kGeo;   // colour l0  [32][64]
constexpr int kOffC1 = kOffC0 + kIn * kHid;    // colour l1  [64][64]
constexpr int kOffC2 = kOffC1 + kHid * kHid;   // colour l2  [64][3]
constexpr int kWeights = kOffC2 + kHid * kRgb; // 9,408

// Row strides in shared memory (bf16 elements), padded by 8 so that the
// rows of a fragment load fall in distinct banks.
constexpr int kLd32 = kIn + 8;
constexpr int kLd64 = kHid + 8;
constexpr int kLdGeo = kGeo + 4;  // float stride of the fp32 [.][16] arrays

// Forward weights, transposed to [out][in]: a B fragment's two k values
// are neighbours.
constexpr int kSD0t = 0;                       // [64][kLd32]
constexpr int kSD1t = kSD0t + kHid * kLd32;    // [16][kLd64]
constexpr int kSC0t = kSD1t + kGeo * kLd64;    // [64][kLd32]
constexpr int kSC1t = kSC0t + kHid * kLd32;    // [64][kLd64]
constexpr int kSC2t = kSC1t + kHid * kLd64;    // [8][kLd64], rows 3-7 zero
constexpr int kFwdElems = kSC2t + 8 * kLd64;
constexpr int kFwdBytes = 2 * kFwdElems;

// Backward's input-gradient weights, [in][out] as the leaves: B(k = out,
// n = in) = W[in][out].
constexpr int kSC1 = kFwdElems;                // [64][kLd64]
constexpr int kSC0g = kSC1 + kHid * kLd64;     // colour l0's geo rows [16][kLd64]
constexpr int kSD0 = kSC0g + kGeo * kLd64;     // [32][kLd64]
constexpr int kWElems = kSD0 + kIn * kLd64;
// Staging of a chunk (bf16, [sample][feature]).
constexpr int kXf = kWElems;                   // features      [128][kLd32]
constexpr int kDh1 = kXf + kChunk * kLd32;     // density delta [128][kLd64]
constexpr int kH1 = kDh1 + kChunk * kLd64;     // density hidden
constexpr int kXc = kH1 + kChunk * kLd64;      // colour input  [128][kLd32]
constexpr int kD1 = kXc + kChunk * kLd32;      // colour l0 delta
constexpr int kH1c = kD1 + kChunk * kLd64;     // colour hidden 1
constexpr int kD2 = kH1c + kChunk * kLd64;     // colour l1 delta
constexpr int kH2c = kD2 + kChunk * kLd64;     // colour hidden 2
constexpr int kBf16Elems = kH2c + kChunk * kLd64;
// float32 arrays, after the bf16 ones.
constexpr int kFD1 = 0;                        // density l1 [64][kLdGeo]
constexpr int kFC2 = kFD1 + kHid * kLdGeo;     // colour l2 [64][4]
constexpr int kFGeo = kFC2 + kHid * 4;         // geo gradient [128][kLdGeo]
constexpr int kFRgb = kFGeo + kChunk * kLdGeo; // rgb gradient [128][4]
constexpr int kF32Elems = kFRgb + kChunk * 4;
constexpr int kBwdBytes = 2 * kBf16Elems + 4 * kF32Elems;
static_assert((2 * kBf16Elems) % 16 == 0, "float arrays 16-byte aligned");
static_assert(kBwdBytes <= 232448, "backward shared memory");
// The partial sums of the FFMA weight gradients at a block's end reuse the
// staging: 4 x 1,024 (density l1) + 16 x 192 (colour l2) floats.
static_assert(4 * (4 * kHid * kGeo + 16 * kHid * kRgb)
                  <= 2 * (kBf16Elems - kXf), "partials fit the staging");

typedef __nv_bfloat16 bf16;

struct Leaves {
  const float* w[5];  // density l0, l1, colour l0, l1, l2 (float32)
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

__device__ __forceinline__ float relu(float x) { return x > 0.f ? x : 0.f; }

// d (+)= a * b: m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// One layer of a 16-row tile: acc[NT] = a[KT] x B, B(k, n) = w[n * LD + k]
// in shared memory (n the output, k the input), k-tiles in order.
template <int KT, int NT, int LD>
__device__ __forceinline__ void layer(const uint32_t (&a)[KT][4],
                                      const bf16* __restrict__ w,
                                      float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const bf16* p = w + (nt * 8 + g) * LD + kt * 16 + 2 * q;
      mma(acc[nt], a[kt], *reinterpret_cast<const uint32_t*>(p),
          *reinterpret_cast<const uint32_t*>(p + 8));
    }
  }
}

// Accumulators of NT n-tiles as the A fragments of NT / 2 k-tiles, each
// value rounded once to bf16 (after the ReLU where RELU).
template <int NT, bool RELU>
__device__ __forceinline__ void to_a(const float (&c)[NT][4],
                                     uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* x = c[2 * kt + h];
      a[kt][2 * h] = RELU ? pack(relu(x[0]), relu(x[1])) : pack(x[0], x[1]);
      a[kt][2 * h + 1] = RELU ? pack(relu(x[2]), relu(x[3]))
                              : pack(x[2], x[3]);
    }
  }
}

// A bf16 pair kept where the matching activation pair is nonzero (the
// ReLU's gradient: its output, rounded to bf16, is > 0).
__device__ __forceinline__ uint32_t mask(uint32_t d, uint32_t h) {
  return d & (((h & 0xFFFFu) ? 0xFFFFu : 0u) |
              ((h >> 16) ? 0xFFFF0000u : 0u));
}

// A tile's rows in the fragment layout: a lane holds rows g and g + 8.
struct Rows {
  long long r[2];
  bool ok[2];
};

__device__ __forceinline__ Rows tile_rows(long long base, long long n) {
  const int g = (threadIdx.x & 31) >> 2;
  Rows t;
  t.r[0] = base + g;
  t.r[1] = base + g + 8;
  t.ok[0] = t.r[0] < n;
  t.ok[1] = t.r[1] < n;
  return t;
}

// The forward of one 16-sample tile. Activations stay in registers as A
// fragments: f (features), h1 (density hidden), c0 (colour input: geo and
// SH), c1 and c2 (colour hiddens); geo the density outputs' fp32 sums (its
// n-tile 0, column 0 is the log-density), rgb the colour outputs' (columns
// 0-2 of one n-tile).
struct Tile {
  uint32_t f[2][4], h1[4][4], c0[2][4], c1[4][4], c2[4][4];
  float geo[2][4], rgb[4];
};

__device__ __forceinline__ void forward_tile(
    const bf16* __restrict__ feats, const float* __restrict__ sh, int spr,
    const Rows& t, const bf16* __restrict__ s, Tile& x) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          feats + t.r[h] * kIn + kt * 16 + 2 * q);
      x.f[kt][h] = t.ok[h] ? __ldg(row) : 0u;
      x.f[kt][2 + h] = t.ok[h] ? __ldg(row + 4) : 0u;
    }
  }
  float acc[8][4];
  layer<2, 8, kLd32>(x.f, s + kSD0t, acc);
  to_a<8, true>(acc, x.h1);
  layer<4, 2, kLd64>(x.h1, s + kSD1t, x.geo);
  // Colour l0's input: geo (k-tile 0) and the ray's SH (k-tile 1), bf16.
  uint32_t geo_a[1][4];
  to_a<2, false>(x.geo, geo_a);
#pragma unroll
  for (int j = 0; j < 4; ++j) x.c0[0][j] = geo_a[0][j];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (t.ok[h]) {
      const float* ray = sh + (t.r[h] / spr) * kSh + 2 * q;
      lo = __ldg(reinterpret_cast<const float2*>(ray));
      hi = __ldg(reinterpret_cast<const float2*>(ray + 8));
    }
    x.c0[1][h] = pack(lo.x, lo.y);
    x.c0[1][2 + h] = pack(hi.x, hi.y);
  }
  layer<2, 8, kLd32>(x.c0, s + kSC0t, acc);
  to_a<8, true>(acc, x.c1);
  layer<4, 8, kLd64>(x.c1, s + kSC1t, acc);
  to_a<8, true>(acc, x.c2);
  float rgb[1][4];
  layer<4, 1, kLd64>(x.c2, s + kSC2t, rgb);
#pragma unroll
  for (int j = 0; j < 4; ++j) x.rgb[j] = rgb[0][j];
}

// out[o][i] = bf16(w[i][o]) for o < OUT, zero rows up to ROWS.
template <int IN, int OUT, int ROWS, int LD>
__device__ __forceinline__ void stage_t(const float* __restrict__ w,
                                        bf16* __restrict__ out) {
  for (int e = threadIdx.x; e < ROWS * IN; e += blockDim.x) {
    const int o = e / IN, i = e % IN;
    out[o * LD + i] = __float2bfloat16_rn(o < OUT ? __ldg(w + i * OUT + o)
                                                  : 0.f);
  }
}

// out[i][o] = bf16(w[i][o]) for the first ROWS rows.
template <int ROWS, int OUT, int LD>
__device__ __forceinline__ void stage_n(const float* __restrict__ w,
                                        bf16* __restrict__ out) {
  for (int e = threadIdx.x; e < ROWS * OUT; e += blockDim.x) {
    const int i = e / OUT, o = e % OUT;
    out[i * LD + o] = __float2bfloat16_rn(__ldg(w + e));
  }
}

// out[i][o] = float(bf16(w[i][o])), o < OUT, zero columns up to LD.
template <int IN, int OUT, int LD>
__device__ __forceinline__ void stage_f(const float* __restrict__ w,
                                        float* __restrict__ out) {
  for (int e = threadIdx.x; e < IN * LD; e += blockDim.x) {
    const int i = e / LD, o = e % LD;
    out[e] = o < OUT ? __bfloat162float(__float2bfloat16_rn(
                           __ldg(w + i * OUT + o)))
                     : 0.f;
  }
}

__device__ __forceinline__ void stage_forward(const Leaves& L, bf16* s) {
  stage_t<kIn, kHid, kHid, kLd32>(L.w[0], s + kSD0t);
  stage_t<kHid, kGeo, kGeo, kLd64>(L.w[1], s + kSD1t);
  stage_t<kIn, kHid, kHid, kLd32>(L.w[2], s + kSC0t);
  stage_t<kHid, kHid, kHid, kLd64>(L.w[3], s + kSC1t);
  stage_t<kHid, kRgb, 8, kLd64>(L.w[4], s + kSC2t);
}

__global__ void __launch_bounds__(kThreads, 2)
    ngp_mlp_fwd(const bf16* __restrict__ feats, const float* __restrict__ sh,
                long long n, int spr, const __grid_constant__ Leaves L,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  stage_forward(L, s);
  __syncthreads();
  const int lane = threadIdx.x & 31, q = lane & 3;
  const long long tiles = (n + 15) / 16;
  for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += (long long)gridDim.x * kWarps) {
    const Rows t = tile_rows(tile * 16, n);
    Tile x;
    forward_tile(feats, sh, spr, t, s, x);
    // sigma of rows g and g + 8 from the lanes that hold geo column 0.
    const float sg0 = __shfl_sync(~0u, expf(x.geo[0][0]), lane & ~3);
    const float sg1 = __shfl_sync(~0u, expf(x.geo[0][2]), lane & ~3);
    if (q < 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!t.ok[h]) continue;
        const float a = x.rgb[2 * h], b = x.rgb[2 * h + 1];
        *reinterpret_cast<float2*>(out + t.r[h] * 4 + 2 * q) =
            make_float2(a, q == 0 ? b : (h ? sg1 : sg0));
      }
    }
  }
}

// A tile's A fragments into the staging, rows r0 .. r0 + 15.
template <int KT, int LD>
__device__ __forceinline__ void stage_a(const uint32_t (&a)[KT][4],
                                        bf16* __restrict__ dst, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + g + (j & 1) * 8, col = kt * 16 + (j >> 1) * 8 + 2 * q;
      *reinterpret_cast<uint32_t*>(dst + row * LD + col) = a[kt][j];
    }
  }
}

// acc[8] += X^T D over the chunk's samples for rows i0 .. i0 + 15 of X^T
// (X [kChunk][LDX], D [kChunk][kLd64], both bf16 in shared memory).
template <int LDX>
__device__ __forceinline__ void wgrad_mma(const bf16* __restrict__ X, int i0,
                                          const bf16* __restrict__ D,
                                          float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31, r = lane & 7, m = lane >> 3;
#pragma unroll 2
  for (int s0 = 0; s0 < kChunk; s0 += 16) {
    uint32_t a[4];
    ldsm_x4_trans(a, X + (s0 + r + (m >> 1) * 8) * LDX + i0 + (m & 1) * 8);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4_trans(b, D + (s0 + r + (m & 1) * 8) * kLd64 + 16 * p
                           + (m >> 1) * 8);
      mma(acc[2 * p], a, b[0], b[1]);
      mma(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ngp_mlp_bwd(const bf16* __restrict__ feats, const float* __restrict__ sh,
                const float* __restrict__ grad, long long n, int spr,
                const __grid_constant__ Leaves L,
                float* __restrict__ fgrad, float* __restrict__ slabs) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s = reinterpret_cast<bf16*>(smem);
  float* f = reinterpret_cast<float*>(smem + 2 * kBf16Elems);
  stage_forward(L, s);
  stage_n<kHid, kHid, kLd64>(L.w[3], s + kSC1);
  stage_n<kGeo, kHid, kLd64>(L.w[2], s + kSC0g);
  stage_n<kIn, kHid, kLd64>(L.w[0], s + kSD0);
  stage_f<kHid, kGeo, kLdGeo>(L.w[1], f + kFD1);
  stage_f<kHid, kRgb, 4>(L.w[4], f + kFC2);
  __syncthreads();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // This warp's share of the mma weight gradients: one 16-row m-tile of
  // colour l1 (warps 0-3), density l0 (4-5) or colour l0 (6-7), all 64
  // output columns.
  const bf16* wx;
  const bf16* wd;
  int i0, w_off;
  if (warp < 4) {
    wx = s + kH1c, wd = s + kD2, i0 = 16 * warp, w_off = kOffC1;
  } else if (warp < 6) {
    wx = s + kXf, wd = s + kDh1, i0 = 16 * (warp - 4), w_off = kOffD0;
  } else {
    wx = s + kXc, wd = s + kD1, i0 = 16 * (warp - 6), w_off = kOffC0;
  }
  float wacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) wacc[j][0] = wacc[j][1] = wacc[j][2] = wacc[j][3] = 0.f;
  // The FFMA weight gradients: density l1 as 64 blocks of 4 x 4 outputs,
  // each over every 4th sample of a chunk (residue tid & 3); colour l2 as
  // 16 blocks of 4 x 3 over every 16th sample (residue tid & 15).
  const int d1_i = ((tid >> 2) >> 2) * 4, d1_o = ((tid >> 2) & 3) * 4;
  const int d1_r = tid & 3;
  const int c2_i = (tid >> 4) * 4, c2_r = tid & 15;
  float d1acc[4][4], c2acc[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) d1acc[a][b] = 0.f;
#pragma unroll
    for (int b = 0; b < 3; ++b) c2acc[a][b] = 0.f;
  }

  const long long chunks = (n + kChunk - 1) / kChunk;
  const int r0 = 16 * warp;
  for (long long chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const Rows t = tile_rows(chunk * kChunk + r0, n);
    Tile x;
    forward_tile(feats, sh, spr, t, s, x);
    // Each layer's input and delta go to the staging once last used here.
    stage_a<2, kLd32>(x.f, s + kXf, r0);
    stage_a<2, kLd32>(x.c0, s + kXc, r0);
    float4 gr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      gr[h] = t.ok[h] ? __ldg(reinterpret_cast<const float4*>(grad) + t.r[h])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    // Colour l2 (FFMA, float32 gradient): the delta at colour hidden 2.
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 w = *reinterpret_cast<const float4*>(
            f + kFC2 + (nt * 8 + 2 * q + e) * 4);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          acc[nt][2 * h + e] = fmaf(gr[h].z, w.z,
                                    fmaf(gr[h].y, w.y, gr[h].x * w.x));
      }
    }
    uint32_t d2[4][4];
    to_a<8, false>(acc, d2);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j) d2[kt][j] = mask(d2[kt][j], x.c2[kt][j]);
    stage_a<4, kLd64>(x.c2, s + kH2c, r0);
    stage_a<4, kLd64>(d2, s + kD2, r0);
    // Colour l1's input gradient (mma), rounded, masked: colour l0's delta.
    layer<4, 8, kLd64>(d2, s + kSC1, acc);
    uint32_t d1[4][4];
    to_a<8, false>(acc, d1);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j) d1[kt][j] = mask(d1[kt][j], x.c1[kt][j]);
    stage_a<4, kLd64>(x.c1, s + kH1c, r0);
    stage_a<4, kLd64>(d1, s + kD1, r0);
    // Colour l0's input gradient at geo (fp32 sums), plus sigma's.
    float dg[2][4];
    layer<4, 2, kLd64>(d1, s + kSC0g, dg);
    if (q == 0) {
      dg[0][0] += gr[0].w * expf(x.geo[0][0]);
      dg[0][2] += gr[1].w * expf(x.geo[0][2]);
    }
    float* geo_rows = f + kFGeo + r0 * kLdGeo;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(geo_rows + (g + 8 * h) * kLdGeo + nt * 8
                                   + 2 * q) =
            make_float2(dg[nt][2 * h], dg[nt][2 * h + 1]);
    if (q < 2) {
      const float4 v = q == 0 ? gr[0] : gr[1];
      *reinterpret_cast<float4*>(f + kFRgb + (r0 + g + 8 * q) * 4) =
          make_float4(v.x, v.y, v.z, 0.f);
    }
    __syncwarp();
    // Density l1 (FFMA, float32 gradient): the delta at density hidden.
    float4 dgr[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dgr[h][k] = *reinterpret_cast<const float4*>(
            geo_rows + (g + 8 * h) * kLdGeo + 4 * k);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* wr = f + kFD1 + (nt * 8 + 2 * q + e) * kLdGeo;
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(wr + 4 * k);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sum[h] = fmaf(dgr[h][k].x, w.x, sum[h]);
            sum[h] = fmaf(dgr[h][k].y, w.y, sum[h]);
            sum[h] = fmaf(dgr[h][k].z, w.z, sum[h]);
            sum[h] = fmaf(dgr[h][k].w, w.w, sum[h]);
          }
        }
        acc[nt][e] = sum[0];
        acc[nt][2 + e] = sum[1];
      }
    }
    uint32_t dh1[4][4];
    to_a<8, false>(acc, dh1);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh1[kt][j] = mask(dh1[kt][j], x.h1[kt][j]);
    stage_a<4, kLd64>(x.h1, s + kH1, r0);
    stage_a<4, kLd64>(dh1, s + kDh1, r0);
    // Density l0's input gradient: the features', float32.
    float fg[4][4];
    layer<4, 4, kLd64>(dh1, s + kSD0, fg);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (t.ok[h])
          *reinterpret_cast<float2*>(fgrad + t.r[h] * kIn + nt * 8 + 2 * q) =
              make_float2(fg[nt][2 * h], fg[nt][2 * h + 1]);
    __syncthreads();

    // The chunk's weight gradients.
    if (warp < 4)
      wgrad_mma<kLd64>(wx, i0, wd, wacc);
    else
      wgrad_mma<kLd32>(wx, i0, wd, wacc);
    for (int j = d1_r; j < kChunk; j += 4) {
      const uint2 hv = *reinterpret_cast<const uint2*>(s + kH1 + j * kLd64
                                                       + d1_i);
      const float4 dv = *reinterpret_cast<const float4*>(f + kFGeo
                                                         + j * kLdGeo + d1_o);
      const float hx[4] = {lo_f(hv.x), hi_f(hv.x), lo_f(hv.y), hi_f(hv.y)};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        d1acc[a][0] = fmaf(hx[a], dv.x, d1acc[a][0]);
        d1acc[a][1] = fmaf(hx[a], dv.y, d1acc[a][1]);
        d1acc[a][2] = fmaf(hx[a], dv.z, d1acc[a][2]);
        d1acc[a][3] = fmaf(hx[a], dv.w, d1acc[a][3]);
      }
    }
    for (int j = c2_r; j < kChunk; j += 16) {
      const uint2 hv = *reinterpret_cast<const uint2*>(s + kH2c + j * kLd64
                                                       + c2_i);
      const float4 gv = *reinterpret_cast<const float4*>(f + kFRgb + j * 4);
      const float hx[4] = {lo_f(hv.x), hi_f(hv.x), lo_f(hv.y), hi_f(hv.y)};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        c2acc[a][0] = fmaf(hx[a], gv.x, c2acc[a][0]);
        c2acc[a][1] = fmaf(hx[a], gv.y, c2acc[a][1]);
        c2acc[a][2] = fmaf(hx[a], gv.z, c2acc[a][2]);
      }
    }
    __syncthreads();
  }

  // The block's slab: the mma sums directly, the FFMA partials through the
  // staging, summed over their residues in order.
  float* slab = slabs + (long long)blockIdx.x * kWeights;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(slab + w_off + (i0 + g + 8 * h) * kHid
                                 + nt * 8 + 2 * q) =
          make_float2(wacc[nt][2 * h], wacc[nt][2 * h + 1]);
  float* part = reinterpret_cast<float*>(s + kXf);
  float* p1 = part;                          // [4][64 x 16]
  float* p2 = part + 4 * kHid * kGeo;        // [16][64 x 3]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      p1[d1_r * kHid * kGeo + (d1_i + a) * kGeo + d1_o + b] = d1acc[a][b];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      p2[c2_r * kHid * kRgb + (c2_i + a) * kRgb + b] = c2acc[a][b];
  }
  __syncthreads();
  for (int e = tid; e < kHid * kGeo; e += kThreads) {
    float v = p1[e];
    for (int r = 1; r < 4; ++r) v += p1[r * kHid * kGeo + e];
    slab[kOffD1 + e] = v;
  }
  for (int e = tid; e < kHid * kRgb; e += kThreads) {
    float v = p2[e];
    for (int r = 1; r < 16; ++r) v += p2[r * kHid * kRgb + e];
    slab[kOffC2 + e] = v;
  }
}

// out[e] = sum of the slabs' e-th values, slab 0 first.
__global__ void __launch_bounds__(256)
    ngp_mlp_wgrad_reduce(const float* __restrict__ slabs, int nslabs,
                         float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kWeights) return;
  float v = 0.f;
  for (int b = 0; b < nslabs; ++b) v += __ldg(slabs + (long long)b * kWeights + e);
  out[e] = v;
}

int make_leaves(Leaves& L, const long long* w) {
  for (int k = 0; k < 5; ++k) {
    if (w[k] == 0) return (int)cudaErrorInvalidValue;
    L.w[k] = reinterpret_cast<const float*>(w[k]);
  }
  return 0;
}

}  // namespace

extern "C" {

// The number of values in a slab: the five leaves' weights.
int cvnerf_ngp_mlp_weights(void) { return kWeights; }

// Samples of a backward chunk (a block's unit of work and of staging).
int cvnerf_ngp_mlp_chunk(void) { return kChunk; }

// Forward over n samples: feats [n, 32] bf16, sh [n / spr, 16] float32
// (sample i reads row i / spr), w the five leaves' device pointers (float32,
// [in][out]); writes out [n, 4] float32 (RGB logits, sigma). grid blocks of
// 256 threads. Returns cudaGetLastError() of the launch.
int cvnerf_ngp_mlp_fwd(const void* feats, const void* sh, long long n,
                       int spr, const long long* w, void* out, int grid,
                       void* stream) {
  Leaves L;
  const int err = make_leaves(L, w);
  if (err != 0) return err;
  if (n < 1 || spr < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  ngp_mlp_fwd<<<grid, kThreads, kFwdBytes, (cudaStream_t)stream>>>(
      (const bf16*)feats, (const float*)sh, n, spr, L, (float*)out);
  return (int)cudaGetLastError();
}

// Backward over n samples: grad [n, 4] float32, the forward's inputs;
// writes the features' gradient fgrad [n, 32] float32 and grid slabs of
// cvnerf_ngp_mlp_weights() partial weight gradients (slabs, float32).
int cvnerf_ngp_mlp_bwd(const void* feats, const void* sh, const void* grad,
                       long long n, int spr, const long long* w, void* fgrad,
                       void* slabs, int grid, void* stream) {
  Leaves L;
  const int err = make_leaves(L, w);
  if (err != 0) return err;
  if (n < 1 || spr < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  // Above 48 KB of shared memory once a device; the first launch on a
  // device is eager (every caller warms up before it captures).
  static bool attr[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        ngp_mlp_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdBytes);
    if (e != cudaSuccess) return (int)e;
    attr[dev] = true;
  }
  ngp_mlp_bwd<<<grid, kThreads, kBwdBytes, (cudaStream_t)stream>>>(
      (const bf16*)feats, (const float*)sh, (const float*)grad, n, spr, L,
      (float*)fgrad, (float*)slabs);
  return (int)cudaGetLastError();
}

// The weight gradients [cvnerf_ngp_mlp_weights()] float32 (the five leaves
// in order, each [in][out]) as the sum of nslabs slabs, in slab order.
int cvnerf_ngp_mlp_wgrad_reduce(const void* slabs, int nslabs, void* out,
                                void* stream) {
  if (nslabs < 1) return (int)cudaErrorInvalidValue;
  ngp_mlp_wgrad_reduce<<<(kWeights + 255) / 256, 256, 0,
                         (cudaStream_t)stream>>>((const float*)slabs, nslabs,
                                                 (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
