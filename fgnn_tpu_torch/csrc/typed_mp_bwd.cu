// Typed-edge gather + edge-type mix + K-aggregation, backward (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel fgnn_tpu/ops/fused_mp.py:_bwd_kernel in
// both of its modes, the backward of typed_mp_fwd.cu.  From the cotangent
// g (B, Nd, C) of out, the per-edge cotangent
//
//   dm[b, d, k, c] = g[b, d, c] * [argmax[b, d, c] == k]      max (first win)
//                    g[b, d, c]                              sum
//                    g[b, d, c] / K                          mean
//                    g[b, d, c] * exp(g (m_k - out[b, d, c])) softmax
//
// (softmax recomputes m_k in the forward's order and takes the saved out as
// the log-sum-exp), then, with hg[b, d, k] the row sum the edge (d, k) read
// in the forward (h[b, nn_idx[d, k]] for NO_EXTENSION, h[b, 2 d] +
// h[b, 2 nn_idx[d, k] + 1] for DIFF/NEIGHBOR, typed_mp_fwd.cu),
//
//   d_etype[b, d, k, t] = sum_c dm[b, d, k, c] * hg[b, d, k, t, c]
//   dh[b, r, t, c]      = sum_{e = d*K + k : edge e reads row r}
//                             dm[b, d, k, c] * etype[b, d, k, t]
//
// Layouts: g, out (B, Nd, C) f32; argmax (B, Nd, C) uint8; h, dh
// (B, R N_src, T, C) f32 with R = 1, or 2 for the extensions; nn_idx (Nd, K)
// int32; etype, d_etype (B, Nd, K, T) f32; the transposed table src_ptr
// (R N_src + 1) and src_edge (R Nd K) int32, the edges that read row r in
// ascending order.  For the extensions that is d's own K edges for the self
// row 2 d and j's in-edges for the neighbour row 2 j + 1
// (ops/typed_mp.py:GatherTable builds both forms), so dh needs no code of
// its own for them.
//
// What bounds it on the H100: bytes, not operations.  At the LDPC f2v shape
// (B=256, N_src=48, Nd=96, K=3, T=4, C=64) it must read g 6.3 MB, argmax
// 1.6 MB, h 12.6 MB and etype 1.2 MB and write dh 12.6 MB and d_etype
// 1.2 MB: about 35 MB, or 11 us at 3.35 TB/s, against 75 MFLOP (about 1 us
// of f32 FMA).  At the synthetic hop conv (B=32, N=Nd=60, K=9, T=16, C=64,
// an extension) it moves h and dh 15.7 MB each and etype and d_etype 1.1 MB
// each: 34 MB, or 10 us, against 0.1 GFLOP (under 2 us).  The design streams
// those bytes and nothing else:
//   * no one-hot gather or scatter matmuls and none of the TPU kernel's
//     k-major (T, N, B*C) layouts: h rows are indexed by nn_idx, and dh
//     walks the transposed table, built once on the host;
//   * dm is rebuilt in registers from g and the argmax wherever it is
//     needed and never reaches memory;
//   * d_etype: the lanes of one row (b, d) run along c in 16-byte vectors
//     (C % 4 == 0), keep T partial sums in registers and reduce them with
//     warp shuffles, so each K*T output is written once;
//   * dh: one thread per (b, row, 4 channels) walks the row's edges in the
//     table's order; for each it reads g, the argmax and the T etype values
//     once and accumulates T outputs in registers, then writes each dh
//     vector once: no atomics, so two runs give the same bits.  A g row is
//     read once by each of its K edges' sources (3x for f2v, 6x for v2f);
//     at these sizes g fits the 50 MB L2.
// The two __global__ functions run one after the other on one stream,
// behind one C entry point.  The kernel allocates nothing and never
// synchronises; the wrapper (fgnn_tpu_torch/ops/fused_mp.py) checks the
// arguments and allocates the outputs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Agg { AGG_MAX = 0, AGG_SUM = 1, AGG_MEAN = 2, AGG_SOFTMAX = 3 };

constexpr int MAX_T = 16;   // partial sums kept in registers by d_etype
constexpr int T_CHUNK = 4;  // types per pass of dh over a source's in-edges
constexpr int THREADS = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void load_u8(const uint8_t* p, int* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { p[0] = v[0]; }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void load_u8(const uint8_t* p, int* v) {
    const uchar4 q = __ldg(reinterpret_cast<const uchar4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// The source row that edge (d, k) reads in sample block h_b: row
// j = nn_idx[d, k], or the neighbour row 2 j + 1 for the extensions.
template <bool EXT>
__device__ __forceinline__ const float* edge_row(const float* h_b,
                                                 const int32_t* nn_idx, int d,
                                                 int K, int k, size_t TC) {
  constexpr int R = EXT ? 2 : 1;
  const int j = __ldg(nn_idx + (size_t)d * K + k);
  return h_b + ((size_t)j * R + (R - 1)) * TC;
}

// The self row 2 d that every edge of d reads for the extensions (nullptr
// for NO_EXTENSION).
template <bool EXT>
__device__ __forceinline__ const float* self_row(const float* h_b, int d,
                                                 size_t TC) {
  return EXT ? h_b + (size_t)d * 2 * TC : nullptr;
}

// The row sum hg at channels c..c+VEC-1 of type t, as the forward forms it.
template <int VEC, bool EXT>
__device__ __forceinline__ void row_sum(const float* hs, const float* hself,
                                        int t, int C, int c, float* hv) {
  Vec<VEC>::load(hs + (size_t)t * C + c, hv);
  if (EXT) {
    float sv[VEC];
    Vec<VEC>::load(hself + (size_t)t * C + c, sv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) hv[i] = sv[i] + hv[i];
  }
}

// The message m_k at channels c..c+VEC-1, in typed_mp_fwd.cu's order.
template <int VEC, bool EXT>
__device__ __forceinline__ void message(const float* hs, const float* hself,
                                        const float* e, int T, int C, int c,
                                        float* m) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) m[i] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float w = __ldg(e + t);
    float hv[VEC];
    row_sum<VEC, EXT>(hs, hself, t, C, c, hv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) m[i] = fmaf(w, hv[i], m[i]);
  }
}

// dm of edge slot k at row offset `off` (= (b*Nd + d)*C + c).  For softmax,
// hs, hself and e are the edge's rows and etype, to recompute m_k.
template <int AGG, int VEC, bool EXT>
__device__ __forceinline__ void cotangent(const float* g, const uint8_t* argmax,
                                          const float* out, size_t off, int k,
                                          float inv_k, float gamma,
                                          const float* hs, const float* hself,
                                          const float* e, int T, int C, int c,
                                          float* dm) {
  Vec<VEC>::load(g + off, dm);
  if (AGG == AGG_MAX) {
    int a[VEC];
    Vec<VEC>::load_u8(argmax + off, a);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dm[i] = a[i] == k ? dm[i] : 0.f;
  } else if (AGG == AGG_MEAN) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dm[i] *= inv_k;
  } else if (AGG == AGG_SOFTMAX) {
    float m[VEC], o[VEC];
    message<VEC, EXT>(hs, hself, e, T, C, c, m);
    Vec<VEC>::load(out + off, o);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dm[i] *= expf(gamma * (m[i] - o[i]));
  }
}

// d_etype.  blockIdx.x walks (b, tile of blockDim.y rows d); the
// blockDim.x lanes of a row (a power of two <= 32, so a row lies in one
// warp) stride over its C / VEC vectors.
template <int AGG, int VEC, bool EXT>
__global__ void d_etype_kernel(const float* __restrict__ g,
                               const uint8_t* __restrict__ argmax,
                               const float* __restrict__ h,
                               const int32_t* __restrict__ nn_idx,
                               const float* __restrict__ etype,
                               const float* __restrict__ out,
                               float* __restrict__ d_etype, int N, int Nd,
                               int K, int T, int C, float gamma) {
  const int tiles = (Nd + blockDim.y - 1) / blockDim.y;
  const int b = blockIdx.x / tiles;
  const int d_raw = (blockIdx.x % tiles) * blockDim.y + threadIdx.y;
  // rows past the end compute row Nd - 1 and write nothing: every lane of
  // the warp must reach the shuffles
  const bool valid = d_raw < Nd;
  const int d = valid ? d_raw : Nd - 1;

  const size_t TC = (size_t)T * C;
  const size_t row = (size_t)b * Nd + d;
  const float* h_b = h + (size_t)b * N * (EXT ? 2 : 1) * TC;
  const float* hself = self_row<EXT>(h_b, d, TC);
  const float inv_k = 1.f / (float)K;
  for (int k = 0; k < K; ++k) {
    const float* hs = edge_row<EXT>(h_b, nn_idx, d, K, k, TC);
    const float* e = etype + (row * K + k) * T;
    float part[MAX_T];
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) part[t] = 0.f;
    for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
      float dm[VEC];
      cotangent<AGG, VEC, EXT>(g, argmax, out, row * C + c, k, inv_k, gamma,
                               hs, hself, e, T, C, c, dm);
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < T) {
          float hv[VEC];
          row_sum<VEC, EXT>(hs, hself, t, C, c, hv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) part[t] = fmaf(dm[i], hv[i], part[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) {
      if (t < T) {
        float v = part[t];
        for (int lane = blockDim.x / 2; lane > 0; lane >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, lane);
        if (valid && threadIdx.x == 0) d_etype[(row * K + k) * T + t] = v;
      }
    }
  }
}

// dh.  One thread per (b, row j of h, vector of VEC channels), c fastest.
// It walks the edges that read row j once per chunk of T_CHUNK types (once
// for T <= T_CHUNK), reads each edge's g, argmax and etype once for the
// whole chunk, and keeps T_CHUNK x VEC partial sums in registers.
template <int AGG, int VEC, bool EXT>
__global__ void dh_kernel(const float* __restrict__ g,
                          const uint8_t* __restrict__ argmax,
                          const float* __restrict__ h,
                          const int32_t* __restrict__ nn_idx,
                          const int32_t* __restrict__ src_ptr,
                          const int32_t* __restrict__ src_edge,
                          const float* __restrict__ etype,
                          const float* __restrict__ out,
                          float* __restrict__ dh, int B, int N, int Nd, int K,
                          int T, int C, float gamma) {
  const int rows = N * (EXT ? 2 : 1);  // rows of h per sample
  const int cv = C / VEC;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * rows * cv) return;
  const int c = (int)(i % cv) * VEC;
  i /= cv;
  const int j = (int)(i % rows);
  const int b = (int)(i / rows);

  const size_t TC = (size_t)T * C;
  const float* h_b = h + (size_t)b * rows * TC;
  const float* hj = h_b + (size_t)j * TC;
  float* dhj = dh + ((size_t)b * rows + j) * TC;
  const float inv_k = 1.f / (float)K;
  const int p0 = __ldg(src_ptr + j);
  const int p1 = __ldg(src_ptr + j + 1);
  for (int t0 = 0; t0 < T; t0 += T_CHUNK) {
    float acc[T_CHUNK][VEC];
#pragma unroll
    for (int u = 0; u < T_CHUNK; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[u][v] = 0.f;
    for (int p = p0; p < p1; ++p) {
      const int e = __ldg(src_edge + p);
      const int d = e / K;
      const int k = e - d * K;
      const size_t row = (size_t)b * Nd + d;
      const float* et = etype + (row * K + k) * T;
      // softmax recomputes m_k from the edge's rows: for NO_EXTENSION its
      // source row is j itself
      const float* hs = EXT && AGG == AGG_SOFTMAX
                            ? edge_row<EXT>(h_b, nn_idx, d, K, k, TC) : hj;
      float dm[VEC];
      cotangent<AGG, VEC, EXT>(g, argmax, out, row * C + c, k, inv_k, gamma,
                               hs, self_row<EXT>(h_b, d, TC), et, T, C, c,
                               dm);
#pragma unroll
      for (int u = 0; u < T_CHUNK; ++u) {
        if (t0 + u < T) {
          const float w = __ldg(et + t0 + u);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[u][v] = fmaf(dm[v], w, acc[u][v]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < T_CHUNK; ++u)
      if (t0 + u < T) Vec<VEC>::store(dhj + (size_t)(t0 + u) * C + c, acc[u]);
  }
}

template <int AGG, int VEC, bool EXT>
int launch(cudaStream_t s, const float* g, const uint8_t* argmax,
           const float* h, const int32_t* nn_idx, const int32_t* src_ptr,
           const int32_t* src_edge, const float* etype, const float* out,
           float* dh, float* d_etype, int B, int N, int Nd, int K, int T,
           int C, float gamma) {
  const int cv = C / VEC;
  int lanes = 1;  // lanes per row: the power of two >= min(cv, 32)
  while (lanes < cv && lanes < 32) lanes *= 2;
  const int rows = THREADS / lanes;
  const long long blocks_e = (long long)B * ((Nd + rows - 1) / rows);
  const long long blocks_h =
      ((long long)B * N * (EXT ? 2 : 1) * cv + THREADS - 1) / THREADS;
  if (blocks_e > INT_MAX || blocks_h > INT_MAX)
    return (int)cudaErrorInvalidValue;
  d_etype_kernel<AGG, VEC, EXT><<<(unsigned)blocks_e, dim3(lanes, rows), 0, s>>>(
      g, argmax, h, nn_idx, etype, out, d_etype, N, Nd, K, T, C, gamma);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dh_kernel<AGG, VEC, EXT><<<(unsigned)blocks_h, THREADS, 0, s>>>(
      g, argmax, h, nn_idx, src_ptr, src_edge, etype, out, dh, B, N, Nd, K, T,
      C, gamma);
  return (int)cudaGetLastError();
}

template <int VEC, bool EXT>
int dispatch(int aggregator, cudaStream_t s, const float* g,
             const uint8_t* argmax, const float* h, const int32_t* nn_idx,
             const int32_t* src_ptr, const int32_t* src_edge,
             const float* etype, const float* out, float* dh, float* d_etype,
             int B, int N, int Nd, int K, int T, int C, float gamma) {
  switch (aggregator) {
    case AGG_MAX:
      return launch<AGG_MAX, VEC, EXT>(s, g, argmax, h, nn_idx, src_ptr, src_edge, etype, out, dh, d_etype, B, N, Nd, K, T, C, gamma);
    case AGG_SUM:
      return launch<AGG_SUM, VEC, EXT>(s, g, argmax, h, nn_idx, src_ptr, src_edge, etype, out, dh, d_etype, B, N, Nd, K, T, C, gamma);
    case AGG_MEAN:
      return launch<AGG_MEAN, VEC, EXT>(s, g, argmax, h, nn_idx, src_ptr, src_edge, etype, out, dh, d_etype, B, N, Nd, K, T, C, gamma);
    case AGG_SOFTMAX:
      return launch<AGG_SOFTMAX, VEC, EXT>(s, g, argmax, h, nn_idx, src_ptr, src_edge, etype, out, dh, d_etype, B, N, Nd, K, T, C, gamma);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int VEC, typename... Args>
int by_ext(int ext, Args... args) {
  return ext ? dispatch<VEC, true>(args...) : dispatch<VEC, false>(args...);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches both kernels on
// `stream` and returns cudaGetLastError() after them, or
// cudaErrorInvalidValue for arguments it does not take.  `argmax` is
// needed for max and `out` for softmax; either may be null otherwise.
// `vec4` asks for the 16-byte path, which needs C % 4 == 0, 16-byte aligned
// g, h, out and dh and a 4-byte aligned argmax.  `ext` selects the
// DIFF/NEIGHBOR mode: h and dh have 2 N rows, Nd == N, and src_ptr/src_edge
// are the 2 N-row table.
extern "C" int typed_mp_bwd(const float* g, const uint8_t* argmax,
                            const float* h, const int32_t* nn_idx,
                            const int32_t* src_ptr, const int32_t* src_edge,
                            const float* etype, const float* out, float* dh,
                            float* d_etype, int B, int N, int Nd, int K, int T,
                            int C, int aggregator, float gamma, int vec4,
                            int ext, void* stream) {
  if (B <= 0 || N <= 0 || Nd <= 0 || K <= 0 || K > 255 || T <= 0 ||
      T > MAX_T || C <= 0 || (vec4 && C % 4 != 0) || (ext && Nd != N) ||
      (aggregator == AGG_MAX && argmax == nullptr) ||
      (aggregator == AGG_SOFTMAX && out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return vec4 ? by_ext<4>(ext, aggregator, s, g, argmax, h, nn_idx, src_ptr,
                          src_edge, etype, out, dh, d_etype, B, N, Nd, K, T, C,
                          gamma)
              : by_ext<1>(ext, aggregator, s, g, argmax, h, nn_idx, src_ptr,
                          src_edge, etype, out, dh, d_etype, B, N, Nd, K, T, C,
                          gamma);
}
