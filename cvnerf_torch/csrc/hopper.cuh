// Hopper (sm_90a) building blocks for the hand-written kernels: mbarriers,
// TMA tile loads and 1-D bulk copies, the ring of weight stages a producer
// fills and consumers drain, wgmma shared-memory descriptors and products
// (bf16 and int8) with the A operand in registers, or (bf16) both operands
// MN-major in shared memory, warpgroup register reallocation, and the
// host-side encoding of TMA tensor maps. PTX as the ISA defines it;
// nothing here allocates or launches.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------ device side
// Shared-memory operands are 32-bit shared-space addresses (smem_addr).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrive and announce `bytes` of asynchronous copies the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Block until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at coordinates (c0 innermost, c1) of `map` into shared
// memory at dst; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Bulk copy: `bytes` (a multiple of 16) from global src (16-byte aligned)
// into shared memory at dst (16-byte aligned); completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma descriptor of a K-major operand tile written by TMA with 128-byte
// swizzle: rows of 128 B (64 bf16 or 128 int8), 8-row atoms 1024 B apart
// (SBO), the tile 1024-byte aligned. Adding 2 to the descriptor moves 32 B
// along K (one wgmma k step: 16 bf16 or 32 int8); adding 64 moves 8 rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t tile) {
  return (uint64_t)((tile & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma descriptor of an MN-major operand tile written by TMA with 128-byte
// swizzle: a box [k rows, 64 bf16] whose rows, 128 B each, run along M (or
// N) at consecutive k, in 8-row atoms 1024 B apart, the tile 1024-byte
// aligned. One product reads one atom column (64 along M or N), so only
// the step between 8-row atoms along K is used; both stride fields hold
// 1024 B. Adding 128 to the descriptor moves 16 rows along K (one wgmma k
// step).
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t tile) {
  return (uint64_t)((tile & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a register that an
// in-flight wgmma owns across this point.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// D[64, 64] (+)= A[64, 16] B[16, 64], bf16 in, fp32 accumulators, A in
// registers (the m16n8k16 A fragment of each warp's 16 rows), B K-major in
// shared memory. scale_d = 0 overwrites D. Accumulator fragment: register
// 4j + i of a thread holds row 16 warp + lane/4 + 8 (i/2), column
// 8j + 2 (lane%4) + (i%2).
#define HOPPER_F8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                     "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t desc,
                                                   int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// D[64, 64] (+)= A[64, 16] B[16, 64], bf16 in, fp32 accumulators, both
// operands in shared memory and MN-major (A's M and B's N contiguous, the
// transpose bits set; desc_sw128_mn). The accumulator fragment is
// wgmma_m64n64k16_rs's.
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float* d, uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 1, 1;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef HOPPER_F8

// D[64, 64] (+)= A[64, 32] B[32, 64], s8 x s8 -> s32, A in registers (the
// m16n8k32 A fragment of each warp's 16 rows: register 0 holds row lane/4,
// k 4 (lane%4) .. +3 as bytes, low byte first; register 1 row + 8; registers
// 2, 3 the same at k + 16), B K-major in shared memory (the only layout
// 8-bit wgmma takes; the integer form has no scale-a/b or transpose
// operands). scale_d = 0 overwrites D. The s32 accumulator fragment is the
// fp32 one of wgmma_m64n64k16_rs.
#define HOPPER_R8(i) "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                     "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int* d, const uint32_t* a, uint64_t desc,
                                                      int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p;\n}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

#undef HOPPER_R8

// Columns of the wgmma shape the kernels issue (m64n64), and a fan-out
// rounded up to whole such products: the rows of a staged weight chunk
// (TMA fills the rows past the matrix, and the columns past its fan-in,
// with zeros).
constexpr int WGMMA_N = 64;
__host__ __device__ inline int wgmma_rows(int n) { return (n + WGMMA_N - 1) / WGMMA_N * WGMMA_N; }

// ------------------------------------------------- the ring of weight stages
// A TMA producer thread fills stages in a fixed order and consumer
// warpgroups drain them in the same order; each stage has a full mbarrier
// (one arrival plus the TMA bytes) and an empty one (one arrival per
// consumer warp). Every thread keeps its own walk (shared-space addresses).
struct Ring {
  uint32_t base, full, empty;  // stage 0, its full and its empty mbarrier
  uint32_t stage_bytes;
  int stages, stage;
  uint32_t phase;
  __device__ __forceinline__ uint32_t tile() const { return base + stage * stage_bytes; }
  __device__ __forceinline__ uint32_t full_bar() const { return full + 8 * stage; }
  __device__ __forceinline__ uint32_t empty_bar(int s) const { return empty + 8 * s; }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer: load the box at (k0, 0) of `map` (`bytes` with the zero fill)
// into the next stage once the consumers have released it.
__device__ __forceinline__ void ring_load(Ring& r, const CUtensorMap* map, int k0,
                                          uint32_t bytes) {
  mbar_wait(r.empty_bar(r.stage), r.phase ^ 1);
  mbar_arrive_expect_tx(r.full_bar(), bytes);
  tma_load_2d(r.tile(), map, r.full_bar(), k0, 0);
  r.advance();
}

struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// Consumer warpgroup: for each of the next `chunks` (<= MAX) stages, wait
// for it to land and issue(kc, desc) its wgmmas as one commit group; once
// the last group is committed, call issued(); a stage is released once
// wgmma.wait_group shows its reads done (one group in flight behind the
// newest). The caller fences its operands.
template <int MAX, class Issue, class Issued = NoHook>
__device__ __forceinline__ void ring_consume(Ring& r, int chunks, const Issue& issue,
                                             const Issued& issued = Issued()) {
  const int lane = threadIdx.x % 32;
  int prev = -1;
#pragma unroll
  for (int kc = 0; kc < MAX; ++kc) {
    if (kc < chunks) {
      mbar_wait(r.full_bar(), r.phase);
      issue(kc, desc_sw128(r.tile()));
      wgmma_commit();
      if (kc == chunks - 1) issued();
      if (prev >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(r.empty_bar(prev));
      }
      prev = r.stage;
      r.advance();
    }
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(r.empty_bar(prev));
}

// Move this warpgroup's register budget (a multiple of 8 in [24, 256]).
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// Barrier `id` (1-15) over `threads` threads, whole warps: wait, or only
// arrive.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda. Null if the driver does not have it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major matrix [rows, cols] of bf16 (elem_bytes 2) or
// int8 (1, mapped as bytes) at `base` (16-byte aligned, rows 16-byte
// multiples), read in boxes of [box_rows, box_cols] with 128-byte swizzle
// (box_cols x elem_bytes = 128); rows and columns past the matrix read as
// zero. Returns a cudaError_t value (0 on success).
inline int make_tmap_sw128(CUtensorMap* map, const void* base, int elem_bytes, int rows,
                           int cols, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
