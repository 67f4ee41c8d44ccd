// The warp-specialised block of the Hopper kernels, shared by the bf16
// forward (fused_mlp.cu, fused_nerf_wgmma), the int8 forward
// (fused_mlp_int8.cu, fused_nerf_int8_wgmma) and the bf16 backward's pass 1
// (fused_mlp_bwd.cu, fused_nerf_bwd_wgmma): one TMA producer warpgroup and
// two wgmma consumer warpgroups of 64 points each, a persistent grid of one
// block per SM walking 128-point tiles, the register budget, the tensor
// maps of the packed matrices, and the staged frequency encoding of a
// warpgroup's points. Namespace bf16wg holds what the two bf16 kernels
// share: their shared-memory plan, the wgmma product of a layer with the
// activations in registers, the A-fragment loads, the bias + ReLU epilogue
// that turns one layer's accumulator into the next layer's A fragment, and
// the bf16 encoding.

#pragma once

#include "hopper.cuh"
#include "nerf_common.cuh"

namespace cvnerf {

constexpr int WG = 128;                      // threads in a warpgroup
constexpr int WG_ROWS = 64;                  // points per consumer warpgroup
constexpr int CONSUMERS = 2;
constexpr int WS_TILE = WG_ROWS * CONSUMERS;  // points per tile
constexpr int WS_THREADS = WG * (CONSUMERS + 1);
constexpr int SMEM_LIMIT = 232448;           // a block's shared memory on sm_90
constexpr int RAW_BYTES = 2 * WG_ROWS * 3 * 4;  // a warpgroup's raw inputs (fp32)
// setmaxnreg moves registers only within the block's own allocation (168 a
// thread at launch, the most 384 threads get): the consumers' gain must
// not exceed what the producer gives up, or setmaxnreg.inc waits forever.
constexpr int LAUNCH_REGS = 168, CONSUMER_REGS = 240, PRODUCER_REGS = 24;
static_assert(CONSUMERS * WG * CONSUMER_REGS + WG * PRODUCER_REGS <= WS_THREADS * LAUNCH_REGS,
              "register budget exceeds the block's allocation");

struct Maps {
  CUtensorMap m[MATS];  // w1, w2..w5, w6a, w6b, w7, w8, w9, w10a, w10b
};

// Blocks of the persistent grid: one per SM, at most one per tile.
inline int ws_grid(int n, int sms) {
  const int tiles = (n + WS_TILE - 1) / WS_TILE;
  return tiles < sms ? tiles : sms;
}

inline int sm_count(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Sum of a value over the 4 threads that share a row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Encode this warpgroup's 64 points, p0..: emit(dir, row, col, value) for
// every real column of freq_encode's layout (pad columns are the caller's),
// dir selecting the view-direction encoding (accurate sinf/cosf: 2^k x is
// exact in fp32, but the phases reach 2^9 |x|, ~3,000 rad at far = 6, where
// __sinf is wrong; rows past n encode the origin and are never written). The 64 x 6 raw inputs are
// staged in `raw` by coalesced loads first (read value by value, their
// latency took half the bf16 kernel's time); then each thread walks the
// bands of three (row, input) pairs, so the sine and cosine of a phase
// share one argument. `bar` is the warpgroup's named barrier, `tid` the
// thread's index in its warpgroup.
template <class Emit>
__device__ __forceinline__ void encode_staged(const float* __restrict__ pts,
                                              const float* __restrict__ dirs, int p0, int n,
                                              const Dims& d, float* raw, int bar, int tid,
                                              const Emit& emit) {
  constexpr int PAIRS = WG_ROWS * 3;
  for (int i = tid; i < 2 * PAIRS; i += WG) {
    const long g = 3L * p0 + i % PAIRS;
    raw[i] = g < 3L * n ? (i < PAIRS ? pts : dirs)[g] : 0.f;
  }
  hopper::named_sync(bar, WG);
  for (int i = tid; i < 2 * PAIRS; i += WG) {
    const bool dir = i >= PAIRS;
    const int r = (i % PAIRS) / 3, c = i % 3, L = dir ? d.Ld : d.Lx;
    const float x = raw[i];
    emit(dir, r, c, x);
    for (int k = 0; k < L; ++k) {
      const float ph = x * (float)(1 << k);  // exact
      emit(dir, r, 3 + 6 * k + c, sinf(ph));
      emit(dir, r, 6 + 6 * k + c, cosf(ph));
    }
  }
}

namespace bf16wg {

using namespace hopper;

constexpr int KCHUNK = 64;                   // k columns a stage holds: one 128 B row
constexpr int MAX_STAGES = 8;
constexpr int ENC_PAD = 8;                   // encoding row padding (bank spread)
constexpr int NB = WGMMA_N;                  // columns of one wgmma (m64n64k16)

// Shared-memory plan (bytes from a 1024-aligned base; `total` includes the
// alignment slack): the weight stages [S][wgmma_rows(W) x 128 B], then each
// consumer warpgroup's region of wg_bytes: `own` bytes of the kernel's own
// (a multiple of 16), then its encodings enc_x [64, KX+8] and enc_d
// [64, KD+8] (bf16) and raw inputs [2][64 x 3] (fp32); then S full and S
// empty mbarriers. As many stages as fit, at most MAX_STAGES.
struct Bf16Plan {
  int stages, ldx, ldd;
  size_t stage_bytes, enc_at, wg_bytes, bars_at, total;
};

__host__ __device__ inline Bf16Plan bf16_plan(const Dims& d, size_t own = 0) {
  Bf16Plan p;
  p.ldx = d.KX + ENC_PAD;
  p.ldd = d.KD + ENC_PAD;
  p.stage_bytes = (size_t)wgmma_rows(d.W) * KCHUNK * 2;
  p.wg_bytes = own + (size_t)WG_ROWS * (p.ldx + p.ldd) * 2 + RAW_BYTES;
  const size_t enc = (size_t)CONSUMERS * p.wg_bytes;
  const size_t room = SMEM_LIMIT - 1024 - enc - 2 * MAX_STAGES * 8;
  p.stages = (int)(room / p.stage_bytes);
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  p.enc_at = p.stages * p.stage_bytes;
  p.bars_at = p.enc_at + enc;
  p.total = 1024 + p.bars_at + 2 * p.stages * 8;
  return p;
}

// acc[64, N] (+)= A[64, K] B^T for the next ceil(K/64) staged chunks of a
// K-major matrix B [N, K] (a packed [out, in] block in the forwards, an
// [in, out] block in the backward's input gradients); A is this
// warpgroup's register fragment a[k16] (k16 < K/16). first: the product
// overwrites acc (else adds to it).
__device__ __forceinline__ void product(float (&acc)[128], uint32_t (&a)[16][4], int K, int N,
                                        bool first, Ring& r) {
  // Every write of acc and a happens before the fence, in program order.
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_operand(a[i][j]);
  wgmma_fence();
  ring_consume<256 / KCHUNK>(r, (K + KCHUNK - 1) / KCHUNK, [&](int kc, uint64_t desc) {
#pragma unroll
    for (int kk = 0; kk < KCHUNK / 16; ++kk) {
      const int k16 = kc * (KCHUNK / 16) + kk;
      if (k16 * 16 < K) {
        const int scale_d = (first && k16 == 0) ? 0 : 1;
#pragma unroll
        for (int nb = 0; nb < 256 / NB; ++nb) {
          // B rows nb*NB..: 8-row atoms of 1024 B, i.e. 64 descriptor
          // units each; the k16 step: 32 B, i.e. 2.
          if (nb * NB < N)
            wgmma_m64n64k16_rs(&acc[nb * NB / 2], a[k16], desc + 2 * kk + nb * NB * 8, scale_d);
        }
      }
    }
  });
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
}

// a[k16] <- A fragments of this warp's rows of E [64, ld] (bf16, shared),
// k < K: a[k16] = {(r, k0..k0+1), (r+8, k0..), (r, k0+8..), (r+8, k0+8..)}
// with r = 16 warp + lane/4 and k0 = 16 k16 + 2 (lane%4).
__device__ __forceinline__ void load_frags(uint32_t (&a)[16][4], const __nv_bfloat16* E, int ld,
                                           int K) {
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* r0 = E + (warp * 16 + lane / 4) * ld + 2 * (lane % 4);
  const __nv_bfloat16* r8 = r0 + 8 * ld;
#pragma unroll
  for (int k16 = 0; k16 < 16; ++k16) {
    if (k16 * 16 < K) {
      a[k16][0] = *reinterpret_cast<const uint32_t*>(r0 + k16 * 16);
      a[k16][1] = *reinterpret_cast<const uint32_t*>(r8 + k16 * 16);
      a[k16][2] = *reinterpret_cast<const uint32_t*>(r0 + k16 * 16 + 8);
      a[k16][3] = *reinterpret_cast<const uint32_t*>(r8 + k16 * 16 + 8);
    }
  }
}

// Encode this warpgroup's 64 points, p0.., into ex [64, ldx] and ed
// [64, ldd] (bf16, freq_encode's layout, zero pad columns) by
// encode_staged.
__device__ __forceinline__ void encode_wg(const float* __restrict__ pts,
                                          const float* __restrict__ dirs, int p0, int n,
                                          const Dims& d, int KX, int KD, __nv_bfloat16* ex,
                                          int ldx, __nv_bfloat16* ed, int ldd, float* raw,
                                          int bar, int tid) {
  encode_staged(pts, dirs, p0, n, d, raw, bar, tid, [&](bool dir, int r, int col, float v) {
    (dir ? ed + r * ldd : ex + r * ldx)[col] = __float2bfloat16(v);
  });
  // The pad columns lie in the last 16 of each row.
  for (int i = tid; i < WG_ROWS * 16; i += WG) {
    const int r = i / 16, c = i % 16;
    if (KX - 16 + c >= 3 + 6 * d.Lx) ex[r * ldx + KX - 16 + c] = __float2bfloat16(0.f);
    if (KD - 16 + c >= 3 + 6 * d.Ld) ed[r * ldd + KD - 16 + c] = __float2bfloat16(0.f);
  }
}

// a <- bf16(act(acc + bias)) over N columns: the accumulator fragment of one
// layer is the A fragment of the next (column group 2 c16 + h of the
// accumulator is k group h of k16 step c16).
__device__ __forceinline__ void epilogue(const float (&acc)[128], uint32_t (&a)[16][4],
                                         const float* __restrict__ bias, int N, bool relu) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c * 16 < N) {
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(bias + c * 16 + 2 * q));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias + c * 16 + 8 + 2 * q));
      float v[8] = {acc[8 * c + 0] + b0.x, acc[8 * c + 1] + b0.y, acc[8 * c + 2] + b0.x,
                    acc[8 * c + 3] + b0.y, acc[8 * c + 4] + b1.x, acc[8 * c + 5] + b1.y,
                    acc[8 * c + 6] + b1.x, acc[8 * c + 7] + b1.y};
      if (relu) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = fmaxf(v[i], 0.f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) a[c][i] = pack_bf16(v[2 * i], v[2 * i + 1]);
    }
  }
}

}  // namespace bf16wg

}  // namespace cvnerf
