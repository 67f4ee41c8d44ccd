// Backward of the fused frequency-encode -> NeRF MLP, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// ops/pallas/fused_mlp_bwd.py::_bwd_pallas (pallas_call at fused_mlp_bwd.py:207,
// body _bwd_kernel :52-151), the VJP of fused_nerf_train_apply. Given the
// upstream g[n, 4] (d rgb, d sigma) it recomputes the forward of each tile of
// points through the forward kernel's own code (nerf_common.cuh), then
// backpropagates through the 12 layers and returns the weight and bias
// gradients summed over all points, fp32, in the packed operand layout
// (nerf_common.cuh). Gradients reach the parameters only: d(points) and
// d(viewdirs) are zero by contract, and layer 1's input gradient is never
// formed. The cast points are the JAX kernel's:
//   * each ReLU mask is h > 0 of the recomputed, compute-dtype-rounded h;
//   * each upstream delta is rounded to the compute dtype before it enters
//     either product (wgrad and dgrad); bias gradients sum the fp32 delta;
//   * l9 has no ReLU; sigma's delta enters h8 through wa; l6 splits into its
//     hidden part (dgrad to h5) and its xyz-encoding part (wgrad only); l10
//     into its feat part and its dir-encoding part (wgrad only).
//
// Bound on this card: operations. The least work is the weight gradient of
// all 12 layers plus the input gradient of all but l1, about 2x the forward's
// 1,186,816 FLOP per point. This design also recomputes the forward (3x the
// forward in all), as the JAX kernel does, so that no activation is kept
// between the forward and the backward pass.
//
// Two passes per chunk of up to CHUNK_POINTS points, then one reduction:
//   1. fused_nerf_bwd_kernel: one block walks tiles of TILE points (32 in
//      bf16, 16 in fp32). A tile's encodings and ten recomputed activations
//      stay in shared memory, as do two ping-pong delta buffers. The dgrad
//      products are the forward's warp-tiled products (wmma bf16 with fp32
//      accumulators, FFMA in fp32, never TF32) on the weights in the
//      [out, in] layout (a transposed copy in fp32), so that adjacent
//      threads read adjacent weights; the ReLU mask, the sigma term and the
//      cast happen in the epilogue, which also forms per-column partial
//      bias sums. The small
//      head gradients (w11, wa, all biases) go into the block's own fp32
//      vector slab. Every weight-gradient operand (the ten layer inputs and
//      the ten rounded deltas) is stashed to device memory in the compute
//      dtype.
//   2. wgrad_gemm: G = D^T H of each weight block over the chunk's points,
//      one 64x64 output tile per block and split-K over the points; each
//      split writes its own fp32 partial.
//   3. reduce_slabs sums the partials (and the vector slabs) in a fixed
//      order. No float atomics anywhere, so the same inputs give
//      bitwise-identical gradients on every launch (the TPU kernel's
//      sequential-grid accumulation does not carry over to a parallel grid).
// A weight gradient sums over all points, so it is one product with K = n;
// done per tile (K = TILE) it would read and write the whole gradient once
// per tile of points.

#include "nerf_common.cuh"

namespace {

using namespace cvnerf;

constexpr int CHUNK_POINTS = 1 << 18;  // points per pass 1 + pass 2
constexpr int SPLIT_POINTS = 16384;    // points per split-K partial (about)
constexpr int MAX_SPLITS = 16;
constexpr int KT = 32;                 // wgrad_gemm: points per k-step
constexpr int MT = 64, NT = 64;        // wgrad_gemm: output tile

template <typename T>
__host__ __device__ constexpr int bwd_tile() {
  return sizeof(T) == 2 ? 32 : 16;
}

// ------------------------------------------------------------ the stash
// Operands of the weight gradients, each [rows, width] row-major in the
// compute dtype. Layer inputs: 0 enc_x (KX), 1 enc_d (KD), 2..9 h1..h8,
// 10 feat (W). Deltas (the rounded d of each layer's output): 0..7 d1..d8,
// 8 d feat (W), 9 d h10 (H).
constexpr int N_ACT = 11, N_DEL = 10;

__host__ __device__ inline int act_width(int a, const Dims& d) {
  return a == 0 ? d.KX : a == 1 ? d.KD : d.W;
}
__host__ __device__ inline int del_width(int k, const Dims& d) { return k == 9 ? d.H : d.W; }

struct Stash {
  long act[N_ACT], del[N_DEL], total;  // element offsets
};

__host__ __device__ inline Stash stash_plan(const Dims& d, long rows) {
  Stash s;
  long p = 0;
  for (int a = 0; a < N_ACT; ++a) { s.act[a] = p; p += rows * act_width(a, d); }
  for (int k = 0; k < N_DEL; ++k) { s.del[k] = p; p += rows * del_width(k, d); }
  s.total = p;
  return s;
}

// Copy a tile's rows [TILE, width] from shared memory (row stride lds) to
// rows p0.. of a stash operand, 16 bytes at a time.
template <typename T, int TILE>
__device__ __forceinline__ void stash_rows(const T* src, int lds, T* dst, int width, int p0) {
  constexpr int V = 16 / sizeof(T);
  const int vw = width / V;
  for (int idx = threadIdx.x; idx < TILE * vw; idx += THREADS) {
    const int r = idx / vw, c = (idx % vw) * V;
    *reinterpret_cast<uint4*>(dst + (long)(p0 + r) * width + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// ------------------------------------------------------------ pass 1
// Backward epilogue: v = (acc + wa[col] * round(d sigma[row])) * (h > 0),
// stored rounded to the compute dtype; the fp32 v feeds the bias sums.
template <typename T>
struct EpiDelta {
  const T* mask;       // h whose ReLU gates this delta, or nullptr (l9)
  int ldm;
  const float* wa;     // sigma head weights, only for d h8
  const float* g;      // the tile's upstream gradient [TILE, 4]
  T* out;
  int ldo;
  __device__ __forceinline__ float operator()(int row, int col, float acc) const {
    float v = acc;
    if (wa != nullptr) v += wa[col] * round_to<T>(g[row * 4 + 3]);
    if (mask != nullptr && !(to_float(mask[row * ldm + col]) > 0.f)) v = 0.f;
    out[row * ldo + col] = from_float<T>(v);
    return v;
  }
};

// D_prev[TILE, N] = epi(D[TILE, K] @ W^T): W is a layer's block in the
// [out=K, in=N] layout (row-major), read as the product's row-major B.
template <int TILE, typename T>
__device__ __forceinline__ void dgrad(const T* D, int ldd, int K, const T* W, int N,
                                      const EpiDelta<T>& e, float* scratch, float* colpart) {
  gemm<TILE, false, true>(D, ldd, K, W, N, nullptr, 0, 0, nullptr, 0, N, scratch, colpart,
                          e);
}

// gb[c] += the column sums gemm left in colpart (groups in fixed order).
__device__ void add_colsums(const float* colpart, int groups, int N, float* gb) {
  for (int c = threadIdx.x; c < N; c += THREADS) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += colpart[g * N + c];
    gb[c] += s;
  }
}

// Shared-memory plan, in bytes: ten activations [TILE, W+PAD], enc_x, enc_d,
// two deltas [TILE, W+PAD], the tile's g [TILE, 4], (bf16) the warps'
// scratch, and the column partials [groups, W].
template <typename T>
struct Plan {
  size_t act[10], ex, ed, dc[2], g, sc, cp, total;
};

template <typename T>
__host__ __device__ inline Plan<T> smem_plan(const Dims& d) {
  constexpr int TILE = bwd_tile<T>();
  Plan<T> s;
  size_t p = 0;
  const size_t act = align128((size_t)TILE * (d.W + PAD) * sizeof(T));
  for (int i = 0; i < 10; ++i) { s.act[i] = p; p += act; }
  s.ex = p; p += align128((size_t)TILE * (d.KX + PAD) * sizeof(T));
  s.ed = p; p += align128((size_t)TILE * (d.KD + PAD) * sizeof(T));
  s.dc[0] = p; p += act;
  s.dc[1] = p; p += act;
  s.g = p; p += align128(TILE * 4 * sizeof(float));
  s.sc = p; if (sizeof(T) == 2) p += WARPS * 256 * sizeof(float);
  s.cp = p; p += align128((size_t)colgroups<T, TILE>() * d.W * sizeof(float));
  s.total = p;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_nerf_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                      const float* __restrict__ gout, const T* __restrict__ wmat,
                      const T* __restrict__ wout, const float* __restrict__ wvec,
                      float* __restrict__ vslabs,
                      long vstride, T* __restrict__ stash, Stash sp, int n, Dims d) {
  constexpr int TILE = bwd_tile<T>();
  constexpr int GROUPS = colgroups<T, TILE>();
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan<T> pl = smem_plan<T>(d);
  T* h[10];
  for (int i = 0; i < 10; ++i) h[i] = reinterpret_cast<T*>(smem + pl.act[i]);
  T* enc_x = reinterpret_cast<T*>(smem + pl.ex);
  T* enc_d = reinterpret_cast<T*>(smem + pl.ed);
  T* dcA = reinterpret_cast<T*>(smem + pl.dc[0]);
  T* dcB = reinterpret_cast<T*>(smem + pl.dc[1]);
  float* gt = reinterpret_cast<float*>(smem + pl.g);
  float* scratch = reinterpret_cast<float*>(smem + pl.sc);
  float* colpart = reinterpret_cast<float*>(smem + pl.cp);
  const int ld = d.W + PAD, ldx = d.KX + PAD, ldd = d.KD + PAD;
  const int W = d.W, H = d.H;
  const Offsets o = offsets(d);
  float* Gv = vslabs + blockIdx.x * vstride;   // this block's vector slab
  const float* w11 = wvec + o.w11;
  T* const h8 = h[7];
  T* const feat = h[8];
  T* const h10 = h[9];
  const int tiles = (n + TILE - 1) / TILE;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * TILE;
    encode_tile<T, TILE>(pts, dirs, p0, n, d, enc_x, ldx, enc_d, ldd);
    for (int idx = threadIdx.x; idx < TILE * 4; idx += THREADS) {
      const int p = p0 + idx / 4;
      gt[idx] = p < n ? gout[4L * p + idx % 4] : 0.f;   // pad rows add nothing
    }
    __syncthreads();
    forward_tile<T, TILE>(enc_x, ldx, enc_d, ldd, wmat, wvec, d, o, h, ld, nullptr, scratch);
    stash_rows<T, TILE>(enc_x, ldx, stash + sp.act[0], d.KX, p0);
    stash_rows<T, TILE>(enc_d, ldd, stash + sp.act[1], d.KD, p0);
    for (int i = 0; i < 9; ++i) stash_rows<T, TILE>(h[i], ld, stash + sp.act[2 + i], W, p0);

    // ---- heads: w11, b11, wa, ba, and d h10 (-> dcA, b10).
    for (int idx = threadIdx.x; idx < 3 * H; idx += THREADS) {
      const int c = idx / H, k = idx % H;
      float s = 0.f;
      for (int t = 0; t < TILE; ++t)
        s = fmaf(round_to<T>(gt[t * 4 + c]), to_float(h10[t * ld + k]), s);
      Gv[o.w11 + idx] += s;
    }
    for (int j = threadIdx.x; j < W; j += THREADS) {
      float s = 0.f;
      for (int t = 0; t < TILE; ++t)
        s = fmaf(round_to<T>(gt[t * 4 + 3]), to_float(h8[t * ld + j]), s);
      Gv[o.wa + j] += s;
    }
    for (int k = threadIdx.x; k < H; k += THREADS) {
      float s = 0.f;
      for (int t = 0; t < TILE; ++t) {
        float v = 0.f;
        for (int c = 0; c < 3; ++c) v = fmaf(w11[c * H + k], round_to<T>(gt[t * 4 + c]), v);
        if (!(to_float(h10[t * ld + k]) > 0.f)) v = 0.f;
        dcA[t * ld + k] = from_float<T>(v);
        s += v;
      }
      Gv[o.b10 + k] += s;
    }
    if (threadIdx.x < 4) {
      float s = 0.f;
      for (int t = 0; t < TILE; ++t) s += gt[t * 4 + threadIdx.x];
      Gv[(threadIdx.x < 3 ? o.b11 + threadIdx.x : o.ba)] += s;
    }
    __syncthreads();
    stash_rows<T, TILE>(dcA, ld, stash + sp.del[9], H, p0);

    // ---- d feat = d h10 @ w10a^T (l9 has no ReLU; -> dcB, b9).
    dgrad<TILE>(dcA, ld, H, wout + o.w10a, W,
                EpiDelta<T>{nullptr, 0, nullptr, gt, dcB, ld}, scratch, colpart);
    __syncthreads();
    add_colsums(colpart, GROUPS, W, Gv + o.b[8]);
    stash_rows<T, TILE>(dcB, ld, stash + sp.del[8], W, p0);
    __syncthreads();

    // ---- d h8 = (d feat @ w9^T + wa * d sigma) * (h8 > 0) (-> dcA, b8).
    dgrad<TILE>(dcB, ld, W, wout + o.w9, W,
                EpiDelta<T>{h8, ld, wvec + o.wa, gt, dcA, ld}, scratch, colpart);
    __syncthreads();
    add_colsums(colpart, GROUPS, W, Gv + o.b[7]);
    stash_rows<T, TILE>(dcA, ld, stash + sp.del[7], W, p0);
    __syncthreads();

    // ---- trunk l8 .. l2: d h_{L-1} from d h_L (-> b_{L-1}).
    const long wt[7] = {o.w8, o.w7, o.w6a, o.w5, o.w4, o.w3, o.w2};
    T* cur = dcA;
    T* nxt = dcB;
#pragma unroll
    for (int l = 0; l < 7; ++l) {       // layer L = 8 - l, its input h[6 - l]
      const T* hin = h[6 - l];
      dgrad<TILE>(cur, ld, W, wout + wt[l], W,
                  EpiDelta<T>{hin, ld, nullptr, gt, nxt, ld}, scratch, colpart);
      __syncthreads();
      add_colsums(colpart, GROUPS, W, Gv + o.b[6 - l]);
      stash_rows<T, TILE>(nxt, ld, stash + sp.del[6 - l], W, p0);
      __syncthreads();
      T* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
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

__host__ __device__ inline int job_tiles(const Job& j) {
  return ((j.M + MT - 1) / MT) * ((j.N + NT - 1) / NT);
}

__host__ __device__ inline int wgrad_tiles(const Dims& d) {
  const Offsets o = offsets(d);
  int t = 0;
  for (int q = 0; q < JOBS; ++q) t += job_tiles(wgrad_job(q, d, o));
  return t;
}

// The weight block and output tile (m0, n0) of grid column b.
__device__ inline Job locate(int b, const Dims& d, int* m0, int* n0) {
  const Offsets o = offsets(d);
  Job j = wgrad_job(0, d, o);
  for (int q = 0; q < JOBS; ++q) {
    j = wgrad_job(q, d, o);
    if (b < job_tiles(j)) break;
    b -= job_tiles(j);
  }
  const int nt = (j.N + NT - 1) / NT;
  *m0 = (b / nt) * MT;
  *n0 = (b % nt) * NT;
  return j;
}

// bf16: each warp owns one 16-row strip (mi) and two 16-column tiles of the
// 64x64 output; operands staged through shared memory KT points at a time.
__global__ void __launch_bounds__(THREADS)
wgrad_gemm(const __nv_bfloat16* __restrict__ stash, Stash sp, Dims d, int rows, int kc,
           float* __restrict__ part, long pstride) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 Ds[KT][MT + PAD];
  __shared__ __align__(128) __nv_bfloat16 Hs[KT][NT + PAD];
  int m0, n0;
  const Job j = locate(blockIdx.x, d, &m0, &n0);
  const __nv_bfloat16* D = stash + sp.del[j.del];
  const __nv_bfloat16* Hm = stash + sp.act[j.act];
  const int ldD = del_width(j.del, d), ldH = act_width(j.act, d);
  const int k0 = blockIdx.y * kc;
  const int k1 = rows < k0 + kc ? rows : k0 + kc;
  const int warp = threadIdx.x / 32, mi = warp % 4, ni0 = (warp / 4) * 2;
  const bool live = m0 + mi * 16 < j.M;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;   // KT x 64 in 16 B pieces
  for (int k = k0; k < k1; k += KT) {
    uint4 dv = make_uint4(0, 0, 0, 0), hv = dv;
    if (k + r < k1) {
      if (m0 + c < j.M) dv = *reinterpret_cast<const uint4*>(D + (long)(k + r) * ldD + m0 + c);
      if (n0 + c < j.N) hv = *reinterpret_cast<const uint4*>(Hm + (long)(k + r) * ldH + n0 + c);
    }
    *reinterpret_cast<uint4*>(&Ds[r][c]) = dv;
    *reinterpret_cast<uint4*>(&Hs[r][c]) = hv;
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::load_matrix_sync(a, &Ds[kk][mi * 16], MT + PAD);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (n0 + (ni0 + q) * 16 < j.N) {
            wmma::load_matrix_sync(b, &Hs[kk][(ni0 + q) * 16], NT + PAD);
            wmma::mma_sync(acc[q], a, b, acc[q]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  float* G = part + blockIdx.y * pstride + j.goff;
  for (int q = 0; q < 2; ++q) {
    const int col = n0 + (ni0 + q) * 16;
    if (col < j.N)
      wmma::store_matrix_sync(G + (long)(m0 + mi * 16) * j.N + col, acc[q], j.N,
                              wmma::mem_row_major);
  }
}

// fp32: FFMA, never TF32; thread (tx, ty) owns outputs m0 + 4 tx .. +3 by
// inputs n0 + 4 ty .. +3.
__global__ void __launch_bounds__(THREADS)
wgrad_gemm(const float* __restrict__ stash, Stash sp, Dims d, int rows, int kc,
           float* __restrict__ part, long pstride) {
  __shared__ __align__(16) float Ds[KT][MT];
  __shared__ __align__(16) float Hs[KT][NT];
  int m0, n0;
  const Job j = locate(blockIdx.x, d, &m0, &n0);
  const float* D = stash + sp.del[j.del];
  const float* Hm = stash + sp.act[j.act];
  const int ldD = del_width(j.del, d), ldH = act_width(j.act, d);
  const int k0 = blockIdx.y * kc;
  const int k1 = rows < k0 + kc ? rows : k0 + kc;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k = k0; k < k1; k += KT) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {                 // KT x 64 in float4 pieces
      const int idx = threadIdx.x + q * THREADS;
      const int r = idx / 16, c = (idx % 16) * 4;
      float4 dv = make_float4(0.f, 0.f, 0.f, 0.f), hv = dv;
      if (k + r < k1) {
        if (m0 + c < j.M) dv = *reinterpret_cast<const float4*>(D + (long)(k + r) * ldD + m0 + c);
        if (n0 + c < j.N) hv = *reinterpret_cast<const float4*>(Hm + (long)(k + r) * ldH + n0 + c);
      }
      *reinterpret_cast<float4*>(&Ds[r][c]) = dv;
      *reinterpret_cast<float4*>(&Hs[r][c]) = hv;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < KT; ++t) {
      const float4 dv = *reinterpret_cast<const float4*>(&Ds[t][tx * 4]);
      const float4 hv = *reinterpret_cast<const float4*>(&Hs[t][ty * 4]);
      const float dd[4] = {dv.x, dv.y, dv.z, dv.w}, hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(dd[u], hh[v], acc[u][v]);
    }
    __syncthreads();
  }
  const int o0 = m0 + tx * 4;
  if (o0 >= j.M) return;
  float* G = part + blockIdx.y * pstride + j.goff;
  for (int v = 0; v < 4; ++v) {
    const int i = n0 + ty * 4 + v;
    if (i < j.N)
      *reinterpret_cast<float4*>(G + (long)i * j.M + o0) =
          make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
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

// Blocks of pass 1 that fit the device at once (one per SM), queried once
// per device and dtype; negative: -(CUDA error).
template <typename T>
int resident_blocks(const Dims& d) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  const Plan<T> pl = smem_plan<T>(d);
  err = cudaFuncSetAttribute(fused_nerf_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.total);
  if (err != cudaSuccess) return -(int)err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_nerf_bwd_kernel<T>, THREADS, pl.total)) != cudaSuccess)
    return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = sms * per_sm;
  return sms * per_sm;
}

// Byte layout of the workspace: the vector slabs of pass 1, the split-K
// partials of pass 2 and the stash of one chunk, each 256-byte aligned.
struct Workspace {
  long vstride, mstride, rows;
  int vslabs, parts;
  size_t part_at, stash_at, total;
};

template <typename T>
int plan_workspace(int n, const Dims& d, Workspace* w) {
  const int res = resident_blocks<T>(d);
  if (res < 0) return -res;
  const Offsets o = offsets(d);
  const int first = n < CHUNK_POINTS ? n : CHUNK_POINTS;
  const int tiles = (first + bwd_tile<T>() - 1) / bwd_tile<T>();
  w->vslabs = tiles < res ? tiles : res;
  w->parts = 0;
  for (int p0 = 0; p0 < n; p0 += CHUNK_POINTS)
    w->parts += splits_for(n - p0 < CHUNK_POINTS ? n - p0 : CHUNK_POINTS);
  w->rows = round_up_l(first, bwd_tile<T>());
  w->vstride = round_up_l(o.vec_total, 64);
  w->mstride = round_up_l(o.mat_total, 64);
  size_t p = round_up_l((long)w->vslabs * w->vstride * 4, 256);
  w->part_at = p;
  p += round_up_l((long)w->parts * w->mstride * 4, 256);
  w->stash_at = p;
  p += round_up_l(stash_plan(d, w->rows).total * (long)sizeof(T), 256);
  w->total = p;
  return 0;
}

template <typename T>
int launch(const float* pts, const float* dirs, const float* g, const void* wmat,
           const void* wout, const float* wvec, void* ws, size_t ws_bytes, float* out,
           int n, Dims d, cudaStream_t stream) {
  Workspace w;
  int err = plan_workspace<T>(n, d, &w);
  if (err != 0) return err;
  if (ws_bytes < w.total) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* vslabs = reinterpret_cast<float*>(base);
  float* part = reinterpret_cast<float*>(base + w.part_at);
  T* stash = reinterpret_cast<T*>(base + w.stash_at);
  const Plan<T> pl = smem_plan<T>(d);
  const Offsets o = offsets(d);
  const Stash sp = stash_plan(d, w.rows);
  const int gemm_tiles = wgrad_tiles(d);
  if ((err = (int)cudaMemsetAsync(vslabs, 0, (size_t)w.vslabs * w.vstride * 4, stream)) != 0)
    return err;
  int at = 0;   // partials written so far
  for (int p0 = 0; p0 < n; p0 += CHUNK_POINTS) {
    const int cn = n - p0 < CHUNK_POINTS ? n - p0 : CHUNK_POINTS;
    const int tiles = (cn + bwd_tile<T>() - 1) / bwd_tile<T>();
    const int blocks = tiles < w.vslabs ? tiles : w.vslabs;
    fused_nerf_bwd_kernel<T><<<blocks, THREADS, pl.total, stream>>>(
        pts + 3L * p0, dirs + 3L * p0, g + 4L * p0, static_cast<const T*>(wmat),
        static_cast<const T*>(wout), wvec, vslabs, w.vstride, stash, sp, cn, d);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    const int s = splits_for(cn);
    const int kc = (int)round_up_l((cn + s - 1) / s, KT);
    wgrad_gemm<<<dim3(gemm_tiles, s), THREADS, 0, stream>>>(stash, sp, d, cn, kc,
                                                            part + (long)at * w.mstride,
                                                            w.mstride);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    at += s;
  }
  reduce_slabs<<<(unsigned)((o.mat_total + 255) / 256), 256, 0, stream>>>(
      part, w.mstride, w.parts, out, o.mat_total);
  reduce_slabs<<<(unsigned)((o.vec_total + 255) / 256), 256, 0, stream>>>(
      vslabs, w.vstride, w.vslabs, out + o.mat_total, o.vec_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace the backward needs for n points on the current
// device; negative: -(CUDA error).
long cvnerf_fused_nerf_bwd_workspace(int n, int W, int H, int Lx, int Ld, int bf16) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  Workspace w;
  const int err =
      bf16 ? plan_workspace<__nv_bfloat16>(n, d, &w) : plan_workspace<float>(n, d, &w);
  return err != 0 ? -(long)err : (long)w.total;
}

// out[mat + vec] = packed fp32 gradients of the fused MLP at (pts, dirs)
// for upstream g[n, 4]. wout holds wmat's blocks in the [out, in] layout
// (in bf16 that is wmat itself), which the input gradients read. ws holds
// ws_bytes >= cvnerf_fused_nerf_bwd_workspace bytes of device memory (no
// initial contents needed). Launches the passes on `stream` and returns a
// cudaError_t (0 on success); does not synchronise.
int cvnerf_fused_nerf_backward(const float* pts, const float* dirs, const float* g,
                               const void* wmat, const void* wout, const float* wvec,
                               void* ws, long ws_bytes, float* out, int n, int W, int H,
                               int Lx, int Ld, int bf16, void* stream) {
  if (n <= 0) return 0;
  const Dims d = make_dims(W, H, Lx, Ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(pts, dirs, g, wmat, wout, wvec, ws, (size_t)ws_bytes, out,
                                 n, d, s);
  return launch<float>(pts, dirs, g, wmat, wout, wvec, ws, (size_t)ws_bytes, out, n, d, s);
}

}  // extern "C"
