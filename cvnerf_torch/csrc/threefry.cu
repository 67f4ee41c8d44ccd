// Threefry-2x32 counter grids and the keyed Feistel draw of ops/rng.py, on
// the card (sm_90a).
//
// Neither replaces a TPU kernel: the JAX package draws its random numbers in
// plain jnp (its ops/rng.py: threefry2x32, _ray_bits and
// sample_without_replacement, under jax.random's fold_in, split and bits),
// which XLA fuses into the train step's one program. In PyTorch the same
// arithmetic is a chain of elementwise ops on int64 words: ~130 launches a
// threefry, and the Feistel draw (4 threefry rounds a pass, up to ~30
// passes at the lego grid) ran on the host, 14-27 ms of a bf16 step. These
// two kernels make each draw one launch whose inputs (the key words, a step
// index) are read from device memory, so a train step can draw everything
// on the card and be captured in a CUDA graph.
//
// What bounds them on this card: integer operations about as much as
// bytes. A threefry is 20 rounds of add, rotate, xor plus 5 key
// injections, ~80 32-bit operations per counter pair (4.8 ps at 132 SMs x
// 64 lanes x 1.98 GHz), against 8 or 16 bytes written (int64 words, the
// port's representation; 2.4 or 4.8 ps at 3.35 TB/s); the Feistel draw
// is 4 threefry an encryption and 1 + k encryptions an element, k the
// passes its cycle walk takes. Both are simple: one thread per output,
// the words in uint32 registers, the rotations compile-time constants (one
// funnel shift each).
//
// Bit for bit what JAX 0.9.0 draws with jax_threefry_partitionable on: the
// words are uint32 with wrap-around, exactly the integer arithmetic of the
// plain versions in ops/threefry.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (Salmon et al., SC'11), the hash under
// jax.random: (x0, x1) is the counter on entry and the output on return.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0; x1 += k1;
  TF_EVEN x0 += k1; x1 += k2 + 1u;
  TF_ODD  x0 += k2; x1 += k0 + 2u;
  TF_EVEN x0 += k0; x1 += k1 + 3u;
  TF_ODD  x0 += k1; x1 += k2 + 4u;
  TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef TF_ODD
#undef TF_EVEN
#undef TF_ROUND
}

// Output layouts of threefry_bits (ops/threefry.py LAYOUTS).
enum Layout : int { kPair = 0, kXor = 1, kSplit = 2 };

// Counter (c0[r] or 0, c1 + j) for element e = r * cols + j of a rows x cols
// grid, c1 read from device memory (c1p) or passed by value (c1v).
__global__ void threefry_bits_kernel(const int64_t* __restrict__ key,
                                     const int64_t* __restrict__ c0p,
                                     const int64_t* __restrict__ c1p,
                                     int64_t c1v, int64_t n, int64_t cols,
                                     int layout, int64_t width,
                                     int64_t* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int64_t r = e / cols, j = e - r * cols;
  uint32_t x0 = c0p ? (uint32_t)c0p[r] : 0u;
  uint32_t x1 = (uint32_t)((c1p ? c1p[0] : c1v) + j);
  threefry((uint32_t)key[0], (uint32_t)key[1], x0, x1);
  if (layout == kPair) {
    out[2 * e] = x0;
    out[2 * e + 1] = x1;
  } else if (layout == kXor) {
    out[e] = x0 ^ x1;
  } else {                          // [rows, width]: o0 at j, o1 at cols + j
    out[r * width + j] = x0;
    if (cols + j < width) out[r * width + cols + j] = x1;
  }
}

// The 4-round balanced Feistel permutation of [0, 2^(2 hb)), its round
// function the first threefry word of (right, round) under (k0 ^ round, k1).
__device__ __forceinline__ uint32_t encrypt(uint32_t x, uint32_t k0,
                                            uint32_t k1, int hb,
                                            uint32_t mask) {
  uint32_t left = (x >> hb) & mask, right = x & mask;
#pragma unroll
  for (uint32_t rnd = 0; rnd < 4; ++rnd) {
    uint32_t f = right, g = rnd;
    threefry(k0 ^ rnd, k1, f, g);
    const uint32_t next = (left ^ f) & mask;
    left = right;
    right = next;
  }
  return (left << hb) | right;
}

// Element i of sample_without_replacement(key, n, m): encrypt i, walk the
// cycle while out of [0, m) for at most `passes` more encryptions (JAX's
// fori_loop re-encrypts only the out-of-range values, so an element's value
// is the same), then the guard: still out of range gives i.
__global__ void feistel_draw_kernel(const int64_t* __restrict__ key,
                                    int64_t n, uint32_t m, int hb,
                                    int passes, int64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t mask = (1u << hb) - 1u;
  uint32_t y = encrypt((uint32_t)i, k0, k1, hb, mask);
  for (int p = 0; p < passes && y >= m; ++p) y = encrypt(y, k0, k1, hb, mask);
  out[i] = y < m ? (int64_t)y : i;
}

constexpr int kThreads = 256;

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// threefry_bits over `n` = rows x cols counters (see the kernel); key, c0
// (or null) and c1 (or null, then c1v) are int64 device pointers. Launches on
// `stream`; returns cudaGetLastError() of the launch.
int cvnerf_threefry_bits(const void* key, const void* c0, const void* c1,
                         long long c1v, long long n, long long cols,
                         int layout, long long width, void* out,
                         void* stream) {
  if (n <= 0) return 0;
  threefry_bits_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (const int64_t*)c0, (const int64_t*)c1, c1v, n,
      cols, layout, width, (int64_t*)out);
  return (int)cudaGetLastError();
}

// feistel_draw: n distinct indices in [0, m) into out (int64); hb is half
// the Feistel width in bits, passes the static cycle-walk bound.
int cvnerf_feistel_draw(const void* key, long long n, long long m, int hb,
                        int passes, void* out, void* stream) {
  if (n <= 0) return 0;
  feistel_draw_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, n, (uint32_t)m, hb, passes, (int64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
