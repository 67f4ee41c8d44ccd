// The fp32 block of the fused NeRF MLP kernels, shared by the fp32 forward
// (fused_mlp.cu, fused_nerf_ffma) and the fp32 backward's pass 1
// (fused_mlp_bwd.cu, fused_nerf_bwd_ffma): a persistent grid of one block
// per SM walking 64-point tiles; one producer warp whose lane 0 streams
// every layer's weights, tile after tile, in K-slabs of KS rows by 1-D bulk
// copies (cp.async.bulk onto the full mbarrier of a stage) into a ring of
// shared-memory stages; eight consumer warps that multiply on the FFMA pipe
// (true fp32 products, never TF32: the JAX kernels demand
// Precision.HIGHEST), each thread holding an 8 x 8 register micro-tile of a
// layer's output (8 points x 8 columns), both operands read from shared
// memory by 16-byte loads.
//
// Thread (pg, cg) of the 256 consumers (warp w, lane l: pg = 4 (w / 4) +
// l / 8, cg = 8 (w % 4) + l % 8) owns the points point(i) = 4 pg + (i % 4)
// + 32 (i / 4) and the columns col(j) = 4 cg + (j % 4) + 128 (j / 4) of
// every product. So a warp's A loads (one k row of 4 point groups) fall in
// one 64-byte run and its B loads (8 column groups) in one 128-byte run: one
// shared-memory wavefront each, 4 a k step for 64 FFMAs. A layer narrower
// than 256 uses the columns below its width; a fixed width <= 128 (the
// lego head, 128) takes one column chunk a thread (NCH = 1), so every
// thread stays busy.
//
// Activations, deltas and encodings lie in shared memory as [k][64 points]
// fp32 (a k row, 256 B, holds one value of each point), the 16-byte point
// groups of row k XOR-swizzled by (k / 4) % 8 (swz), so that an epilogue,
// whose quarter-warps store 8 rows 4 apart at one point group, hits 8
// different bank groups. The weights are the fp32 packing [in, out]
// (nerf_common.cuh), so a K-slab of a block is KS contiguous rows of its
// fan-out: one bulk copy, no tensor map. A stage holds KS x W floats.

#pragma once

#include "nerf_wgmma.cuh"

namespace cvnerf {
namespace ffma {

using namespace hopper;

constexpr int TILE = 64;               // points a block works on at once
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMER_THREADS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMER_THREADS + 32;  // + the producer warp
constexpr int KS = 16;                 // weight rows (k) a stage holds
constexpr int MAX_STAGES = 8;
constexpr int BAR = 1;                 // named barrier of the consumer threads
constexpr int RAW = TILE * 6 * 4;      // the tile's raw inputs (fp32)

// Shared-memory plan, in bytes from the (16-byte aligned) dynamic base: the
// weight stages [S][KS x W], the activation buffer [W][64], enc_x [KX][64],
// enc_d [KD][64], the raw inputs, `own` bytes of the kernel's own (a
// multiple of 16), then S full and S empty mbarriers. As many stages as
// fit, at most MAX_STAGES.
struct Plan {
  int stages;
  size_t stage_bytes, act_at, ex_at, ed_at, raw_at, own_at, bars_at, total;
};

__host__ __device__ inline Plan plan(const Dims& d, size_t own) {
  Plan p;
  p.stage_bytes = (size_t)KS * d.W * 4;
  const size_t fixed = (size_t)TILE * (d.W + d.KX + d.KD) * 4 + RAW + own;
  const size_t room = SMEM_LIMIT - fixed - 2 * MAX_STAGES * 8;
  p.stages = (int)(room / p.stage_bytes);
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  p.act_at = p.stages * p.stage_bytes;
  p.ex_at = p.act_at + (size_t)TILE * d.W * 4;
  p.ed_at = p.ex_at + (size_t)TILE * d.KX * 4;
  p.raw_at = p.ed_at + (size_t)TILE * d.KD * 4;
  p.own_at = p.raw_at + RAW;
  p.bars_at = p.own_at + own;
  p.total = p.bars_at + 2 * p.stages * 8;
  return p;
}

// Blocks of the persistent grid: one per SM, at most one per tile.
inline int grid(int n, int sms) {
  const int tiles = (n + TILE - 1) / TILE;
  return tiles < sms ? tiles : sms;
}

// Element (k, p) of a [K][64] shared buffer.
__host__ __device__ inline int swz(int k, int p) {
  return k * TILE + (((p >> 2) ^ ((k >> 2) & 7)) << 2) + (p & 3);
}

struct Thr {
  int pg, cg, warp, lane;
  __device__ __forceinline__ int point(int i) const { return 4 * pg + (i & 3) + 32 * (i >> 2); }
  __device__ __forceinline__ int col(int j) const { return 4 * cg + (j & 3) + 128 * (j >> 2); }
};

__device__ __forceinline__ Thr thr() {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  return Thr{4 * (w >> 2) + (l >> 3), 8 * (w & 3) + (l & 7), w, l};
}

// ------------------------------------------------------------ the ring
// Producer: copy `bytes` (a multiple of 16) at src (16-byte aligned) into
// the next stage once the consumer warps have released it.
__device__ __forceinline__ void ring_bulk(Ring& r, const float* src, uint32_t bytes) {
  mbar_wait(r.empty_bar(r.stage), r.phase ^ 1);
  mbar_arrive_expect_tx(r.full_bar(), bytes);
  bulk_load(r.tile(), src, bytes, r.full_bar());
  r.advance();
}

// Producer: every K-slab of the fan-out-N block at src ([K, N] row-major).
__device__ __forceinline__ void stream_block(Ring& r, const float* src, int K, int N) {
  for (int k0 = 0; k0 < K; k0 += KS) ring_bulk(r, src + (long)k0 * N, (uint32_t)KS * N * 4);
}

// Consumer: the ring's stages as generic pointers (stage s at stages +
// s stage_floats).
struct Stages {
  const float* base;
  int stage_floats;
};

// acc[i][j] (+)= sum over k < K of A[k][point(i)] B[k][col(j)], B the next
// K / KS staged slabs of a block N wide (rows of N floats), A a swizzled
// [K][64] buffer; j < 4 NCH. Columns past N read whatever lies there (the
// next rows, another stage or the activation buffer: all in the block's
// shared memory) and are never stored. first: acc starts from 0.
template <int NCH>
__device__ __forceinline__ void product(float (&acc)[8][8], const float* A, int K, int N,
                                        bool first, Ring& r, const Stages& st, const Thr& t) {
  if (first) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += KS) {
    mbar_wait(r.full_bar(), r.phase);
    const float* B = st.base + r.stage * st.stage_floats + 4 * t.cg;
    const float* a = A + k0 * TILE;
    // Row k0 + kk's swizzle: ((k0 + kk) / 4) % 8 = (k0 / 4) % 8 ^ kk / 4
    // (k0 a multiple of 16), the second point group 32 floats on.
    const int x = t.pg ^ ((k0 >> 2) & 4);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float* ar = a + kk * TILE + 4 * (x ^ (kk >> 2));
      const float4 a0 = *reinterpret_cast<const float4*>(ar);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 b0 = *reinterpret_cast<const float4*>(B + kk * N);
      float bv[8] = {b0.x, b0.y, b0.z, b0.w, 0.f, 0.f, 0.f, 0.f};
      if (NCH == 2) {
        const float4 b1 = *reinterpret_cast<const float4*>(B + kk * N + 128);
        bv[4] = b1.x;
        bv[5] = b1.y;
        bv[6] = b1.z;
        bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NCH; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncwarp();
    if (t.lane == 0) mbar_arrive(r.empty_bar(r.stage));
    r.advance();
  }
}

// Column chunk jc (columns 128 jc + 4 cg .. + 3) of this thread lies below N.
__device__ __forceinline__ bool chunk_in(int jc, int N, const Thr& t) {
  return 128 * jc + 4 * t.cg < N;
}

// v[i][j] <- act(v[i][j] + bias[col(j)]) for the columns below N.
template <int NCH>
__device__ __forceinline__ void bias_act(float (&v)[8][8], const float* __restrict__ bias, int N,
                                         bool relu, const Thr& t) {
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc) {
    if (chunk_in(jc, N, t)) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + 128 * jc + 4 * t.cg));
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float x = v[i][4 * jc + jj] + bb[jj];
          v[i][4 * jc + jj] = relu ? fmaxf(x, 0.f) : x;
        }
    }
  }
}

// buf[col(j)][point(i)] <- v[i][j] (swizzled [N][64]) for the columns below N.
template <int NCH>
__device__ __forceinline__ void store_rows(const float (&v)[8][8], float* buf, int N,
                                           const Thr& t) {
#pragma unroll
  for (int jc = 0; jc < NCH; ++jc) {
    if (chunk_in(jc, N, t)) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jc + jj;
        float* row = buf + t.col(j) * TILE + 4 * (t.pg ^ (t.cg & 7));  // (col / 4) % 8 = cg % 8
        *reinterpret_cast<float4*>(row) = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
        *reinterpret_cast<float4*>(row + 32) = make_float4(v[4][j], v[5][j], v[6][j], v[7][j]);
      }
    }
  }
}

// Sum of a value over the 8 threads of a warp that share a point group
// (lanes differing in bits 0-2), in a fixed order.
__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// Sum of a value over the 4 threads of a warp that share a column group
// (lanes differing in bits 3-4), in a fixed order.
__device__ __forceinline__ float col_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Encode the tile's 64 points p0.. into ex [KX][64] and ed [KD][64]
// (swizzled; freq_encode's layout along k; the pad rows are the caller's,
// zeroed once), the values nerf_wgmma.cuh's encode_staged gives (accurate
// sinf/cosf; rows past n encode the origin and are never written). The
// 64 x 6 raw inputs are staged in `raw` by coalesced loads first. Ends
// with the consumers' barrier.
__device__ __forceinline__ void encode(const float* __restrict__ pts,
                                       const float* __restrict__ dirs, int p0, int n,
                                       const Dims& d, float* ex, float* ed, float* raw) {
  constexpr int PAIRS = TILE * 3;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * PAIRS; i += CONSUMER_THREADS) {
    const long g = 3L * p0 + i % PAIRS;
    raw[i] = g < 3L * n ? (i < PAIRS ? pts : dirs)[g] : 0.f;
  }
  named_sync(BAR, CONSUMER_THREADS);
  for (int i = tid; i < 2 * PAIRS; i += CONSUMER_THREADS) {
    const bool dir = i >= PAIRS;
    const int r = (i % PAIRS) / 3, c = i % 3, L = dir ? d.Ld : d.Lx;
    float* E = dir ? ed : ex;
    const float x = raw[i];
    E[swz(c, r)] = x;
    for (int k = 0; k < L; ++k) {
      const float ph = x * (float)(1 << k);  // exact
      E[swz(3 + 6 * k + c, r)] = sinf(ph);
      E[swz(6 + 6 * k + c, r)] = cosf(ph);
    }
  }
  named_sync(BAR, CONSUMER_THREADS);
}

// Zero the pad rows of both encodings (never written by encode).
__device__ __forceinline__ void zero_pad_rows(const Dims& d, float* ex, float* ed) {
  const int x0 = 3 + 6 * d.Lx, d0 = 3 + 6 * d.Ld;
  for (int i = threadIdx.x; i < (d.KX - x0) * TILE; i += CONSUMER_THREADS) ex[x0 * TILE + i] = 0.f;
  for (int i = threadIdx.x; i < (d.KD - d0) * TILE; i += CONSUMER_THREADS) ed[d0 * TILE + i] = 0.f;
}

// Set up the ring's mbarriers (thread 0) and return the block's ring.
__device__ __forceinline__ Ring make_ring(unsigned char* smem, const Plan& pl) {
  const uint32_t base = smem_addr(smem);
  Ring ring{base, base + (uint32_t)pl.bars_at, base + (uint32_t)pl.bars_at + 8 * pl.stages,
            (uint32_t)pl.stage_bytes, pl.stages, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty_bar(s), CONSUMER_WARPS);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  return ring;
}

}  // namespace ffma
}  // namespace cvnerf
