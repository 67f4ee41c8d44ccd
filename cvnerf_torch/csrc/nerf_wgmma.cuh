// The warp-specialised block of the Hopper forward kernels, shared by the
// bf16 (fused_mlp.cu, fused_nerf_wgmma) and int8 (fused_mlp_int8.cu,
// fused_nerf_int8_wgmma) kernels: one TMA producer warpgroup and two wgmma
// consumer warpgroups of 64 points each, a persistent grid of one block per
// SM walking 128-point tiles, the register budget, the tensor maps of the
// packed matrices, and the staged frequency encoding of a warpgroup's
// points.

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
// dir selecting the view-direction encoding, with the values
// nerf_common.cuh's encode_tile gives (accurate sinf/cosf; rows past n
// encode the origin and are never written). The 64 x 6 raw inputs are
// staged in `raw` by coalesced loads first (read value by value, their
// latency took half the bf16 kernel's time); then each thread walks the
// bands of three (row, input) pairs, so the sine and cosine of a phase
// share one argument. `bar` is the warpgroup's named barrier.
template <class Emit>
__device__ __forceinline__ void encode_staged(const float* __restrict__ pts,
                                              const float* __restrict__ dirs, int p0, int n,
                                              const Dims& d, float* raw, int bar,
                                              const Emit& emit) {
  constexpr int PAIRS = WG_ROWS * 3;
  const int tid = threadIdx.x % WG;
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

}  // namespace cvnerf
