// Eval BatchNorm and instance norm, each with the activation that follows
// it, in one pass (Hopper, sm_90a), f32.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses each norm with its activation.  The port's plain PyTorch versions
// (fgnn_tpu_torch/models/norm.py) run them as separate broadcast kernels:
// eval BatchNorm as four passes, ((x - mean) * inv) * weight + bias, and
// instance norm as about five (mean, subtract, square, mean, scale), each
// followed by a ReLU or leaky-ReLU pass, every pass reading and writing the
// whole tensor.  In the LDPC decode they took 45% of the card's time.
//
// What bounds it on the H100: bytes.  Both kernels do a few operations an
// element against 8 bytes moved (x read once, the result written once), far
// below the ridge, so the design is to touch device memory once each way:
//
// * bn_act_kernel on x viewed as (rows, C).  A thread owns V consecutive
//   channels (V = 4, float4 loads and stores, where C % 4 == 0 and both
//   pointers are 16-byte aligned; else V = 1, scalar loads), keeps their
//   mean, inv, weight and bias in registers, and strides over rows, four
//   rows' loads in flight before their stores.  A block of 256 threads takes
//   256 / (C / V) rows a step (grid.y splits C / V above 256); the grid is
//   capped at 8 blocks an SM and strides over the rest.
//   It computes the plain version's operations in its order, each rounded
//   on its own (the _rn intrinsics, so that nothing contracts into an FMA):
//   t = ((x - mean) * inv) * weight + bias, then none, relu or leaky relu.
//   inv = rsqrt(running_var + eps) comes from the wrapper, computed as the
//   plain version computes it, so the output is bit-equal to PyTorch's
//   separate kernels (x - mean is PyTorch's a + (-1) b, which is exact to
//   the same bits).
// * in_act_kernel on x (B, N, C): statistics per (b, c) over N.  One block
//   of 8 warps per (b, tile of 32 channels); lane = channel, warp w takes
//   rows w, w + 8, ...  Each thread keeps its rows in registers (up to
//   IN_CACHE of them: N <= 96 at 8 warps), so the two-pass mean and
//   variance read device memory once; rows beyond that are read again from
//   memory in each pass.  Statistics are f32 with the two-pass variance, as
//   the plain version takes them (a one-pass variance failed golden parity
//   in the JAX package); the warps' partial sums combine in a fixed order,
//   so two launches give the same bits.  1 / sqrtf (correctly rounded)
//   stands for the plain version's rsqrt.  N = 1 gives zeros, as the plain
//   version does.
//
// The activations follow PyTorch's kernels: relu is clamp_min(t, 0), NaN
// passing through; leaky relu is t > 0 ? t : t * slope, with the slope in
// f32 as PyTorch converts it.  Each entry point launches on the caller's
// stream, allocates nothing and never synchronises; it returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.  The wrapper (fgnn_tpu_torch/ops/norm_act.py)
// decides when the kernels run and allocates the output.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SMS = 132;
constexpr int BN_THREADS = 256;
constexpr int BN_BLOCKS_PER_SM = 8;
constexpr int BN_UNROLL = 4;
constexpr int IN_WARPS = 8;
constexpr int IN_CACHE = 12;  // rows a thread keeps in registers

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float t, float slope) {
  if (ACT == ACT_RELU) return isnan(t) ? t : fmaxf(t, 0.f);
  if (ACT == ACT_LEAKY) return t > 0.f ? t : __fmul_rn(t, slope);
  return t;
}

__device__ __forceinline__ float affine(float x, float m, float iv, float w,
                                        float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), iv), w), b);
}

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float& lane(float& v, int) { return v; }
__device__ __forceinline__ float& lane(float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// x and out as (rows, G) vectors of V channels; a block's thread tid takes
// vector g = blockIdx.y * gpb + tid % gpb of rows tid / gpb + k rb.
template <int V, int ACT>
__global__ void __launch_bounds__(BN_THREADS)
bn_act_kernel(const float* __restrict__ x, const float* __restrict__ mean,
              const float* __restrict__ inv, const float* __restrict__ weight,
              const float* __restrict__ bias, float* __restrict__ out,
              long long rows, int G, int gpb, int rb, float slope) {
  using T = typename Vec<V>::T;
  const int g = blockIdx.y * gpb + threadIdx.x % gpb;
  const int rl = threadIdx.x / gpb;
  if (rl >= rb || g >= G) return;
  float m[V], iv[V], w[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = g * V + j;
    m[j] = mean[c];
    iv[j] = inv[c];
    w[j] = weight[c];
    b[j] = bias[c];
  }
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  const long long step = (long long)gridDim.x * rb;
  for (long long r0 = (long long)blockIdx.x * rb + rl; r0 < rows;
       r0 += BN_UNROLL * step) {
    T v[BN_UNROLL];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long r = r0 + u * step;
      if (r < rows) v[u] = xv[r * G + g];
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long r = r0 + u * step;
      if (r >= rows) break;
#pragma unroll
      for (int j = 0; j < V; ++j)
        lane(v[u], j) = activate<ACT>(
            affine(lane(v[u], j), m[j], iv[j], w[j], b[j]), slope);
      ov[r * G + g] = v[u];
    }
  }
}

// x and out (B, N, C); block bid takes sample bid / tiles and channels
// (bid % tiles) * 32 + lane.
template <int ACT>
__global__ void __launch_bounds__(IN_WARPS * 32)
in_act_kernel(const float* __restrict__ x, float* __restrict__ out, int N,
              int C, int tiles, float eps, float slope) {
  __shared__ float part[IN_WARPS][32];
  __shared__ float stat[32];
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const long long b = blockIdx.x / tiles;
  const int c = (blockIdx.x % tiles) * 32 + ln;
  const bool on = c < C;
  const float* xb = x + b * N * C + c;
  float* ob = out + b * N * C + c;
  constexpr int CACHED = IN_CACHE * IN_WARPS;

  // pass 1: the mean
  float v[IN_CACHE];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < IN_CACHE; ++k) {
    const int r = wp + k * IN_WARPS;
    v[k] = on && r < N ? xb[(long long)r * C] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < IN_CACHE; ++k)
    if (wp + k * IN_WARPS < N) s += v[k];
  for (int r = CACHED + wp; r < N; r += IN_WARPS)
    if (on) s += xb[(long long)r * C];
  part[wp][ln] = s;
  __syncthreads();
  if (wp == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < IN_WARPS; ++i) t += part[i][ln];
    stat[ln] = t / (float)N;
  }
  __syncthreads();
  const float mean = stat[ln];

  // pass 2: the biased variance of the deviations
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < IN_CACHE; ++k) {
    if (wp + k * IN_WARPS < N) {
      const float d = v[k] - mean;
      q += d * d;
    }
  }
  for (int r = CACHED + wp; r < N; r += IN_WARPS) {
    if (on) {
      const float d = xb[(long long)r * C] - mean;
      q += d * d;
    }
  }
  __syncthreads();  // every thread has read stat before it is reused
  part[wp][ln] = q;
  __syncthreads();
  if (wp == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < IN_WARPS; ++i) t += part[i][ln];
    stat[ln] = 1.f / sqrtf(t / (float)N + eps);
  }
  __syncthreads();
  const float rs = stat[ln];
  if (!on) return;

  // pass 3: normalise, activate, write once
#pragma unroll
  for (int k = 0; k < IN_CACHE; ++k) {
    const int r = wp + k * IN_WARPS;
    if (r < N)
      ob[(long long)r * C] = activate<ACT>((v[k] - mean) * rs, slope);
  }
  for (int r = CACHED + wp; r < N; r += IN_WARPS)
    ob[(long long)r * C] =
        activate<ACT>((xb[(long long)r * C] - mean) * rs, slope);
}

template <int V>
int launch_bn(int act, dim3 grid, cudaStream_t s, const float* x,
              const float* mean, const float* inv, const float* weight,
              const float* bias, float* out, long long rows, int G, int gpb,
              int rb, float slope) {
  switch (act) {
    case ACT_NONE:
      bn_act_kernel<V, ACT_NONE><<<grid, BN_THREADS, 0, s>>>(
          x, mean, inv, weight, bias, out, rows, G, gpb, rb, slope);
      break;
    case ACT_RELU:
      bn_act_kernel<V, ACT_RELU><<<grid, BN_THREADS, 0, s>>>(
          x, mean, inv, weight, bias, out, rows, G, gpb, rb, slope);
      break;
    default:
      bn_act_kernel<V, ACT_LEAKY><<<grid, BN_THREADS, 0, s>>>(
          x, mean, inv, weight, bias, out, rows, G, gpb, rb, slope);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Eval BatchNorm with its activation: x and out (rows, C), the channel
// vectors mean, inv, weight, bias (C,), all f32.  act: 0 none, 1 relu,
// 2 leaky relu with `slope`.  vec4 asks for float4 loads: C % 4 == 0 and x,
// out 16-byte aligned.
extern "C" int bn_act(const float* x, const float* mean, const float* inv,
                      const float* weight, const float* bias, float* out,
                      long long rows, int C, int vec4, int act, float slope,
                      void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (rows < 0 || C < 0 || act < ACT_NONE || act > ACT_LEAKY ||
      (vec4 && (C % 4 != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || C == 0) return 0;
  const int V = vec4 ? 4 : 1;
  const int G = C / V;                                 // vectors a row
  const int gpb = G < BN_THREADS ? G : BN_THREADS;     // vectors a block
  const int rb = BN_THREADS / gpb;                     // rows a block step
  const int gy = (G + gpb - 1) / gpb;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const long long need = (rows + rb - 1) / rb;
  long long cap = (long long)SMS * BN_BLOCKS_PER_SM / gy;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(need < cap ? need : cap), (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  return vec4 ? launch_bn<4>(act, grid, s, x, mean, inv, weight, bias, out,
                             rows, G, gpb, rb, slope)
              : launch_bn<1>(act, grid, s, x, mean, inv, weight, bias, out,
                             rows, G, gpb, rb, slope);
}

// Instance norm with its activation: x and out (B, N, C) f32, statistics
// per (b, c) over N; act as bn_act's.
extern "C" int in_act(const float* x, float* out, int B, int N, int C,
                      float eps, int act, float slope, void* stream) {
  if (B < 0 || N < 0 || C < 0 || act < ACT_NONE || act > ACT_LEAKY)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N * C == 0) return 0;
  const int tiles = (C + 31) / 32;
  const long long blocks = (long long)B * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
  switch (act) {
    case ACT_NONE:
      in_act_kernel<ACT_NONE><<<nb, IN_WARPS * 32, 0, s>>>(x, out, N, C,
                                                           tiles, eps, slope);
      break;
    case ACT_RELU:
      in_act_kernel<ACT_RELU><<<nb, IN_WARPS * 32, 0, s>>>(x, out, N, C,
                                                           tiles, eps, slope);
      break;
    default:
      in_act_kernel<ACT_LEAKY><<<nb, IN_WARPS * 32, 0, s>>>(x, out, N, C,
                                                            tiles, eps, slope);
  }
  return (int)cudaGetLastError();
}
