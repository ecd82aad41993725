// Typed-edge gather + edge-type mix + K-aggregation, forward (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel fgnn_tpu/ops/fused_mp.py:_fwd_kernel in
// both of its modes.  For every sample b, destination row d and output
// channel c:
//
//   NO_EXTENSION   m[k] = sum_t etype[b, d, k, t] * h[b, nn_idx[d, k], t, c]
//   DIFF/NEIGHBOR  m[k] = sum_t etype[b, d, k, t]
//                         * (h[b, 2 d, t, c] + h[b, 2 nn_idx[d, k] + 1, t, c])
//   out  = AGG_k m[k]   max (first-win argmax, strict >, as the TPU kernel),
//                       sum, mean, or softmax mx + log(sum_k exp(g (m - mx))) / g
//
// h = x @ W_tmajor is computed outside (a plain matmul), as the JAX package
// leaves it to XLA; the bias is added after the kernel.  Layouts:
// h (B, R N_src, T, C) f32, nn_idx (Nd, K) int32, etype (B, Nd, K, T) f32,
// out (B, Nd, C) f32, argmax (B, Nd, C) uint8 (max only, optional).  R is 1
// for NO_EXTENSION and 2 for the extensions, whose h holds two rows per
// node, interleaved: row 2 n is the self row x_n W_a and row 2 n + 1 the
// neighbour row x_n W_b, with W_a = W_self + W_nbr, W_b = -W_nbr (DIFF) or
// W_a = W_self, W_b = W_nbr (NEIGHBOR): the sign is folded into the
// weights, as fused_mp.py:603 folds it into the stacked operand.  The
// extensions index the self row by destination, so they need Nd == N_src.
//
// What bounds it on the H100: bytes and launches, not operations.  At the
// LDPC f2v shape (B=256, N_src=48, Nd=96, K=3, T=4, C=64) the kernel must
// read h 12.6 MB + etype 1.2 MB and write out 6.3 MB (+ argmax 1.6 MB):
// about 20 MB, or 6 us at 3.35 TB/s, against 38 MFLOP (under 1 us of f32
// FMA).  At the synthetic hop conv (B=32, N=Nd=60, K=9, T=16, C=64, an
// extension) it reads h 15.7 MB and etype 1.1 MB and writes 0.6 MB with the
// argmax: 17 MB, or 5 us, against 53 MFLOP.  The design only streams those
// bytes once:
//   * no one-hot gather matmul (the TPU kernel's [onehot(dst) | onehot(src)]
//     for the extensions) and none of its (T, N, B*C) k-major layouts or
//     tile/VMEM policy: h rows are indexed by nn_idx (and by d);
//   * threads run along c in 16-byte vectors where C % 4 == 0, so h rows
//     (T*C contiguous floats) and out rows are read and written coalesced;
//   * each thread reads the K indices and K*T etype values of its row once;
//     threads of one row share them, so each is one broadcast load per warp;
//   * the K reduction runs in registers as the messages are formed (softmax
//     by the online log-sum-exp), so per-edge messages never reach memory;
//   * an h row is read by every edge that sources it (6x for f2v, 3x for
//     v2f, K x for the extensions' rows); at these sizes h fits the 50 MB
//     L2, so device memory sees each byte about once.
// The kernel allocates nothing and never synchronises; the wrapper
// (fgnn_tpu_torch/ops/fused_mp.py) checks the arguments and allocates the
// outputs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Agg { AGG_MAX = 0, AGG_SUM = 1, AGG_MEAN = 2, AGG_SOFTMAX = 3 };

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { p[0] = v[0]; }
  __device__ static void store_u8(uint8_t* p, const int* v) { p[0] = (uint8_t)v[0]; }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void store_u8(uint8_t* p, const int* v) {
    *reinterpret_cast<uchar4*>(p) =
        make_uchar4((uint8_t)v[0], (uint8_t)v[1], (uint8_t)v[2], (uint8_t)v[3]);
  }
};

// blockIdx.x walks (b, tile of blockDim.y destination rows); threadIdx.y
// picks the row, threadIdx.x strides over the row's C / VEC vectors.
template <int AGG, int VEC, bool EXT>
__global__ void typed_mp_fwd_kernel(const float* __restrict__ h,
                                    const int32_t* __restrict__ nn_idx,
                                    const float* __restrict__ etype,
                                    float* __restrict__ out,
                                    uint8_t* __restrict__ argmax,
                                    int N, int Nd, int K, int T, int C,
                                    float gamma) {
  const int tiles = (Nd + blockDim.y - 1) / blockDim.y;
  const int b = blockIdx.x / tiles;
  const int d = (blockIdx.x % tiles) * blockDim.y + threadIdx.y;
  if (d >= Nd) return;

  constexpr int R = EXT ? 2 : 1;  // rows of h per node
  const size_t TC = (size_t)T * C;
  const float* h_b = h + (size_t)b * N * R * TC;
  const float* h_self = h_b + (size_t)d * R * TC;  // read by EXT only
  const float* et_bd = etype + ((size_t)b * Nd + d) * K * T;
  const int32_t* idx_d = nn_idx + (size_t)d * K;
  const size_t o_row = ((size_t)b * Nd + d) * C;

  for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
    float acc[VEC];  // max / running max / running sum
    float s[VEC];    // softmax: sum_k exp(g (m_k - acc))
    int am[VEC];     // max: first-win argmax
    for (int k = 0; k < K; ++k) {
      const float* hs =
          h_b + ((size_t)__ldg(idx_d + k) * R + (R - 1)) * TC + c;
      const float* e = et_bd + (size_t)k * T;
      float m[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = 0.f;
      for (int t = 0; t < T; ++t) {
        const float w = __ldg(e + t);
        float hv[VEC];
        Vec<VEC>::load(hs + (size_t)t * C, hv);
        if (EXT) {
          float sv[VEC];
          Vec<VEC>::load(h_self + (size_t)t * C + c, sv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) hv[i] = sv[i] + hv[i];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) m[i] = fmaf(w, hv[i], m[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (AGG == AGG_MAX) {
          if (k == 0 || m[i] > acc[i]) {  // strict >: the first max wins
            acc[i] = m[i];
            am[i] = k;
          }
        } else if (AGG == AGG_SOFTMAX) {
          if (k == 0) {
            acc[i] = m[i];
            s[i] = 1.f;
          } else if (m[i] > acc[i]) {
            s[i] = s[i] * expf(gamma * (acc[i] - m[i])) + 1.f;
            acc[i] = m[i];
          } else {
            s[i] += expf(gamma * (m[i] - acc[i]));
          }
        } else {
          acc[i] = k == 0 ? m[i] : acc[i] + m[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (AGG == AGG_MEAN) acc[i] = acc[i] / (float)K;
      if (AGG == AGG_SOFTMAX) acc[i] = acc[i] + logf(s[i]) / gamma;
    }
    Vec<VEC>::store(out + o_row + c, acc);
    if (AGG == AGG_MAX && argmax != nullptr) Vec<VEC>::store_u8(argmax + o_row + c, am);
  }
}

template <int AGG, int VEC, bool EXT>
void launch(unsigned blocks, int threads_x, int rows, cudaStream_t stream,
            const float* h, const int32_t* nn_idx, const float* etype,
            float* out, uint8_t* argmax, int N, int Nd, int K, int T, int C,
            float gamma) {
  typed_mp_fwd_kernel<AGG, VEC, EXT>
      <<<blocks, dim3(threads_x, rows), 0, stream>>>(
          h, nn_idx, etype, out, argmax, N, Nd, K, T, C, gamma);
}

template <int VEC, bool EXT>
int dispatch(int aggregator, unsigned blocks, int threads_x, int rows,
             cudaStream_t s, const float* h, const int32_t* nn_idx,
             const float* etype, float* out, uint8_t* argmax, int N, int Nd,
             int K, int T, int C, float gamma) {
  switch (aggregator) {
    case AGG_MAX:
      launch<AGG_MAX, VEC, EXT>(blocks, threads_x, rows, s, h, nn_idx, etype, out, argmax, N, Nd, K, T, C, gamma);
      break;
    case AGG_SUM:
      launch<AGG_SUM, VEC, EXT>(blocks, threads_x, rows, s, h, nn_idx, etype, out, argmax, N, Nd, K, T, C, gamma);
      break;
    case AGG_MEAN:
      launch<AGG_MEAN, VEC, EXT>(blocks, threads_x, rows, s, h, nn_idx, etype, out, argmax, N, Nd, K, T, C, gamma);
      break;
    case AGG_SOFTMAX:
      launch<AGG_SOFTMAX, VEC, EXT>(blocks, threads_x, rows, s, h, nn_idx, etype, out, argmax, N, Nd, K, T, C, gamma);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int VEC, typename... Args>
int by_ext(int ext, Args... args) {
  return ext ? dispatch<VEC, true>(args...) : dispatch<VEC, false>(args...);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.  `argmax` may be null; `vec4` asks for the
// 16-byte path, which needs C % 4 == 0 and 16-byte aligned h and out; `ext`
// selects the DIFF/NEIGHBOR mode, whose h has 2 N rows and needs Nd == N.
extern "C" int typed_mp_fwd(const float* h, const int32_t* nn_idx,
                            const float* etype, float* out, uint8_t* argmax,
                            int B, int N, int Nd, int K, int T, int C,
                            int aggregator, float gamma, int vec4, int ext,
                            void* stream) {
  if (B <= 0 || N <= 0 || Nd <= 0 || K <= 0 || K > 255 || T <= 0 || C <= 0 ||
      (vec4 && C % 4 != 0) || (ext && Nd != N))
    return (int)cudaErrorInvalidValue;
  const int vec = vec4 ? 4 : 1;
  const int cv = C / vec;                     // vectors per row
  const int threads_x = cv < 256 ? cv : 256;  // threads along c
  const int rows = 256 / threads_x;           // destination rows per block
  const long long blocks = (long long)B * ((Nd + rows - 1) / rows);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
  return vec4 ? by_ext<4>(ext, aggregator, nb, threads_x, rows, s, h, nn_idx,
                          etype, out, argmax, N, Nd, K, T, C, gamma)
              : by_ext<1>(ext, aggregator, nb, threads_x, rows, s, h, nn_idx,
                          etype, out, argmax, N, Nd, K, T, C, gamma);
}
