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
// argmax: 17 MB, or 5 us, against 53 MFLOP.
//
// Three routes, each behind its own C entry point; ops/fused_mp.py
// (fwd_sample, fwd_slab) picks one from the shapes alone, before the launch:
//
// * typed_mp_fwd_sample: sample_fwd_kernel, NO_EXTENSION in the bf16 mode
//   (the LDPC path under --bf16).  The first kernel (below) ran 4 channels a
//   thread, 8-byte loads in bf16, as many load instructions as f32 for half
//   the bytes; each thread walked its K edges and T types one after another
//   behind a dependent index load, read every gathered h row from L2 (each
//   row K Nd / N_src times: 6 at LDPC f2v, 3 at v2f), and rounded the same
//   etype weight in each of the C/4 threads of a row: 31% of its byte bound
//   at the LDPC shapes.  Here one block per sample copies the whole of the
//   sample's bf16 h (25-98 KB at the LDPC shapes) into shared memory with
//   16-byte cp.async, so each byte crosses L2 once per block, and rounds the
//   sample's etype once per (d, k, t) into shared memory; a thread then
//   takes 8 channels (16-byte loads) of a row and forms its messages out of
//   shared memory in the kept kernel's order, so out, the argmax and the
//   log-sum-exp keep its bits.  The kept kernel takes a sample too wide for
//   a block, C % 8 != 0, and batches that leave more than half the SMs
//   without a block (ops/fused_mp.py:fwd_sample; timed in chip_smoke.py).
// * typed_mp_fwd: typed_mp_fwd_kernel, the first kernel of the port, every
//   f32 NO_EXTENSION launch.  Threads run along c in 16-byte vectors, a block
//   takes 256 / (C / 4) rows, and each thread forms its row's K messages one
//   after another, reading h rows from L2 by nn_idx (none of the TPU
//   kernel's one-hot gather matmuls, k-major layouts or tile/VMEM policy).
//   At the LDPC batch of 256 that fills the card.  Its bf16 instantiation
//   is the kept route of the bf16 mode (slab=0 in the wrapper), and for the
//   extensions it is kept for graphs too wide to stage; both are the
//   baselines the newer routes are timed against (chip_smoke.py).
// * typed_mp_fwd_staged: staged_fwd_kernel, DIFF/NEIGHBOR.  At the synthetic
//   models' B=32 the first kernel ran 4-30 thousand threads, each through a
//   serial chain of K T steps with two 16-byte L2 loads each, and re-read the
//   self row for every edge (141 MB through L2 at the hop table against
//   17 MB of bytes to move).  Here one block per (sample, slab of Cs
//   channels, tile of rows) copies the slab of the sample's 2 N rows, the
//   rows' etype and their part of the table into shared memory with
//   cp.async, so each byte of h crosses L2 once per block and the K-fold
//   reuse of neighbour rows comes from shared memory.  The work is spread
//   over (row, 4 channels, lane g of G): lane g takes every G-th edge, KC at
//   a time, reading the self row once per type for all of them, and the G
//   lanes combine in a fixed butterfly (no atomics: two launches give the
//   same bits).  Indices split with one multiply (FastDiv).  Row tiles and
//   G come from the shapes, so that the grid keeps most SMs busy at C=2 and
//   a block fills at Nd=30.
//   In the bf16 mode it has two designs (the C entry's `design`).  The kept
//   one (kept=True in the wrapper) is the f32 mode's: the f32 plan
//   (fwd_slab), 8-byte copies and loads of 4 channels, and etype read from
//   L1 and rounded in every lane at each use; it took 1.18 times f32's time
//   on the same launches (PERF.md): in bf16 each value is widened at
//   each use, and each etype weight rounded in every lane that reads it.
//   The bf16 design (design 1, planned
//   by fwd_bf16_plan) rounds the block's rows of etype once per (d, k, t)
//   into shared memory on their way in, copies the slab in 16-byte pieces,
//   takes 8 channels a thread (16-byte loads) where the lanes of a row
//   still carry two edges each, else 4, and gives a lane all of its edges
//   at once (KC up to 4), so that only the last lane of a row has idle
//   slots.  It keeps the kept kernel's order of arithmetic, so max's out
//   and argmax are bit-equal to both kept routes.  Where its launch goes,
//   phase by phase: python -m fgnn_tpu_torch.utils.phases (PERF.md).
//   Copying the slab in two groups, the second behind the first types'
//   messages, did not help, and neither did a slab widened to f32 as it is
//   staged (loads through registers are slower than cp.async); both went.
//
// The first two routes have an f32 and a bf16 mode (the template argument
// TH, the storage type of h and out), as the TPU kernel's mm_dtype; the
// sample route has the bf16 mode only.  The bf16 mode
// reads bf16 h, rounds etype to bf16 as it reads it, forms the messages and
// their aggregate in f32 exactly as the f32 mode does, and rounds out once to
// bf16 on the store; softmax may also write the f32 log-sum-exp (`lse`),
// which the backward needs and a bf16 out no longer holds.  The staged slab
// of a bf16 h takes half the shared memory, in rows padded by the same rule
// counted in bytes.
//
// Each route launches on the caller's stream, allocates nothing and never
// synchronises; the wrapper (fgnn_tpu_torch/ops/fused_mp.py) checks the
// arguments, picks the route and allocates the outputs.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "typed_mp_common.cuh"

namespace {

// One step of the aggregation over k, taken in ascending k: max keeps the
// first maximal k (strict >, as the TPU kernel), softmax the running max
// and sum_k exp(g (m_k - max)) (the online log-sum-exp).
template <int AGG, int VEC>
__device__ __forceinline__ void agg_step(const float* m, int k, bool first,
                                         float gamma, float* acc, float* s,
                                         int* am) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (AGG == AGG_MAX) {
      if (first || m[i] > acc[i]) {  // strict >: the first max wins
        acc[i] = m[i];
        am[i] = k;
      }
    } else if (AGG == AGG_SOFTMAX) {
      if (first) {
        acc[i] = m[i];
        s[i] = 1.f;
      } else if (m[i] > acc[i]) {
        s[i] = s[i] * expf(gamma * (acc[i] - m[i])) + 1.f;
        acc[i] = m[i];
      } else {
        s[i] += expf(gamma * (m[i] - acc[i]));
      }
    } else {
      acc[i] = first ? m[i] : acc[i] + m[i];
    }
  }
}

// out from the aggregate: mean divides by K, softmax adds log(s) / g.
template <int AGG, int VEC>
__device__ __forceinline__ void agg_finish(int K, float gamma, const float* s,
                                           float* acc) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (AGG == AGG_MEAN) acc[i] = acc[i] / (float)K;
    if (AGG == AGG_SOFTMAX) acc[i] = acc[i] + logf(s[i]) / gamma;
  }
}

// --------------------------------------------------------------------------
// the kept route: the first kernel of the port, every NO_EXTENSION launch
// and the DIFF/NEIGHBOR shapes no staged slab fits

// blockIdx.x walks (b, tile of blockDim.y destination rows); threadIdx.y
// picks the row, threadIdx.x strides over the row's C / VEC vectors.
template <int AGG, int VEC, bool EXT, class TH>
__global__ void typed_mp_fwd_kernel(const TH* __restrict__ h,
                                    const int32_t* __restrict__ nn_idx,
                                    const float* __restrict__ etype,
                                    TH* __restrict__ out,
                                    uint8_t* __restrict__ argmax,
                                    float* __restrict__ lse,
                                    int N, int Nd, int K, int T, int C,
                                    float gamma) {
  const int tiles = (Nd + blockDim.y - 1) / blockDim.y;
  const int b = blockIdx.x / tiles;
  const int d = (blockIdx.x % tiles) * blockDim.y + threadIdx.y;
  if (d >= Nd) return;

  constexpr int R = EXT ? 2 : 1;  // rows of h per node
  const size_t TC = (size_t)T * C;
  const TH* h_b = h + (size_t)b * N * R * TC;
  const TH* h_self = h_b + (size_t)d * R * TC;  // read by EXT only
  const float* et_bd = etype + ((size_t)b * Nd + d) * K * T;
  const int32_t* idx_d = nn_idx + (size_t)d * K;
  const size_t o_row = ((size_t)b * Nd + d) * C;

  for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
    float acc[VEC];  // max / running max / running sum
    float s[VEC];    // softmax: sum_k exp(g (m_k - acc))
    int am[VEC];     // max: first-win argmax
    for (int k = 0; k < K; ++k) {
      const TH* hs =
          h_b + ((size_t)__ldg(idx_d + k) * R + (R - 1)) * TC + c;
      const float* e = et_bd + (size_t)k * T;
      float m[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = 0.f;
      for (int t = 0; t < T; ++t) {
        const float w = rnd<TH>(__ldg(e + t));
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
      agg_step<AGG, VEC>(m, k, k == 0, gamma, acc, s, am);
    }
    agg_finish<AGG, VEC>(K, gamma, s, acc);
    Vec<VEC>::store(out + o_row + c, acc);
    if (AGG == AGG_MAX && argmax != nullptr) Vec<VEC>::store_u8(argmax + o_row + c, am);
    if (AGG == AGG_SOFTMAX && lse != nullptr) Vec<VEC>::store(lse + o_row + c, acc);
  }
}

template <int AGG, int VEC, bool EXT, class TH>
void launch(unsigned blocks, int threads_x, int rows, cudaStream_t stream,
            const TH* h, const int32_t* nn_idx, const float* etype, TH* out,
            uint8_t* argmax, float* lse, int N, int Nd, int K, int T, int C,
            float gamma) {
  typed_mp_fwd_kernel<AGG, VEC, EXT, TH>
      <<<blocks, dim3(threads_x, rows), 0, stream>>>(
          h, nn_idx, etype, out, argmax, lse, N, Nd, K, T, C, gamma);
}

template <int VEC, bool EXT, class TH, typename... A>
int dispatch(int aggregator, A... a) {
  switch (aggregator) {
    case AGG_MAX: launch<AGG_MAX, VEC, EXT, TH>(a...); break;
    case AGG_SUM: launch<AGG_SUM, VEC, EXT, TH>(a...); break;
    case AGG_MEAN: launch<AGG_MEAN, VEC, EXT, TH>(a...); break;
    case AGG_SOFTMAX: launch<AGG_SOFTMAX, VEC, EXT, TH>(a...); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int VEC, class TH, typename... Args>
int by_ext(int ext, Args... args) {
  return ext ? dispatch<VEC, true, TH>(args...)
             : dispatch<VEC, false, TH>(args...);
}

// --------------------------------------------------------------------------
// the staged route: DIFF/NEIGHBOR only

constexpr int STAGED_THREADS = 512;  // most threads a block
constexpr int MAX_KC = 4;            // most edges a lane carries at once
constexpr int SMS = 132;             // the H100's SMs

// Row stride of the staged slab of h, in elements of esz bytes.  A warp's
// vector loads (16 bytes of f32, 8 of bf16) run in wavefronts of 128 bytes;
// with the vector index fastest, one wavefront reads 128 / (Cs esz) rows of
// Cs channels, and rows whose stride is Cs elements modulo 128 bytes start
// on distinct bank groups whenever their indices differ modulo that count.
// Other slabs take the backward's stride.  The bf16 design's 16-byte loads
// keep this stride too: of the paddings of a row tried on the H100, this
// one was the fastest at the hop shapes.
__host__ __device__ inline int fwd_row_stride(int T, int cs, int esz) {
  const int w = 128 / esz;  // elements per 128 bytes
  return cs % 4 == 0 && cs < w ? (T * cs + w - 1) / w * w + cs
                               : row_stride(T, cs, esz);
}

// Shared memory of one block, in bytes, each region 16-byte aligned: hs,
// the slab of h (rows, T, cs) in rows of fwd_row_stride elements; nn
// (nd K), the block's part of the table; with `et` (the bf16 design) ws,
// the block's rows of etype (nd K T) rounded to bf16 and held as f32.
inline size_t fwd_staged_bytes(int rows, int nd, int K, int T, int cs,
                               int esz, bool et) {
  return pad16((size_t)rows * fwd_row_stride(T, cs, esz) * esz) +
         4 * pad4((size_t)nd * K) + (et ? 4 * pad4((size_t)nd * K * T) : 0);
}

// The 4 types t0..t0+3 of an etype row w (types past T are never used).
__device__ __forceinline__ void etype_run(const float* w, int t0, int T,
                                          bool vec, float* v) {
  if (vec) {
    Vec<4>::load(w + t0, v);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = t0 + u < T ? __ldg(w + t0 + u) : 0.f;
  }
}

// Block blockIdx.x = (b S + s) tiles + tile takes sample b's channels
// [s Cs, (s+1) Cs) for destination rows [tile R, (tile+1) R), R =
// tile_rows.  It stages the slab of all 2 N rows of h and its rows' part of
// the table with cp.async, then runs one item per (row d, vector of
// channels, lane g of G = 1 << lg).  The vector index runs
// fastest where the G cv lanes of a row fit in a warp (`vec_fast`), else g.
// Lane g takes the edges k = g, g + G, ... in ascending order, KC at a
// time: for each type t it loads the self row once and the KC neighbour
// rows together (so that their latencies overlap; the arithmetic then runs
// for all KC slots), and forms m_k exactly as the kept kernel does (the two
// rows added, then fmaf over ascending t from 0).  A lane folds its edges
// into its aggregate in ascending k; the G lanes then combine in a fixed
// butterfly.  For max the butterfly keeps the lower k on a tie, so out and
// the argmax are those of one pass over k: bit-equal to the kept kernel.
//
// ET selects the bf16 design (typed_mp_fwd_staged's `design` 1, bf16
// only): the block also stages its rows' etype and rounds it to bf16 once
// per (d, k, t) in shared memory (ws); it copies the slab in 16-byte
// pieces wherever a row of one type is whole 16-byte vectors, where a
// thread takes 8 channels (VEC 8, 16-byte loads); and a lane carries all
// of its edges at once (KC up to 4), so that no slot of a chunk is idle
// but the last lane's.  Without ET (the design of the f32 mode, and the
// kept bf16 route) every lane reads etype from global memory (through L1)
// and rounds it at each use.
template <int AGG, int VEC, int KC, class TH, bool ET>
__global__ void __launch_bounds__(STAGED_THREADS)
staged_fwd_kernel(const TH* __restrict__ h,
                  const int32_t* __restrict__ nn_idx,
                  const float* __restrict__ etype, TH* __restrict__ out,
                  uint8_t* __restrict__ argmax, float* __restrict__ lse,
                  int N, int K, int T, int C, int Cs, int tiles,
                  int tile_rows, int lg, int vec_fast, float gamma) {
  constexpr int ESZ = (int)sizeof(TH);
  constexpr int EPC = 16 / ESZ;  // elements per 16-byte copy
  extern __shared__ __align__(16) float smem[];
  const int Nd = N;
  const int S = C / Cs;
  const int bs = blockIdx.x / tiles;
  const int tile = blockIdx.x - bs * tiles;
  const int b = bs / S;
  const int c0 = (bs - b * S) * Cs;
  const int d0 = tile * tile_rows;
  const int nd = min(tile_rows, Nd - d0);
  const int rows = 2 * N;
  const int cv = Cs / VEC;  // vectors per slab row
  const int RS = fwd_row_stride(T, Cs, ESZ);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const FastDiv by_cv(cv), by_t(T);
  TH* hs = reinterpret_cast<TH*>(smem);
  int* nn = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                   pad16((size_t)rows * RS * ESZ));
  float* ws = reinterpret_cast<float*>(nn + pad4((size_t)nd * K));  // ET

  // 1. stage the slab of h and the rows' part of the table (and etype)
  const TH* hb = h + (size_t)b * rows * T * C + c0;
  const bool h16 = RS % EPC == 0 && (reinterpret_cast<uintptr_t>(hb) & 15) == 0;
  if (Cs == C && (T * C) % EPC == 0 && h16) {
    // the slab is the whole row: 16-byte copies at any C
    const int q4 = T * C / EPC;
    const FastDiv by_q4(q4);
    for (int q = tid; q < rows * q4; q += nt) {
      const int r = by_q4(q);
      const int o = EPC * (q - r * q4);
      cp_async(hs + (size_t)r * RS + o, hb + (size_t)r * T * C + o, 16);
    }
  } else if (ET && Cs % EPC == 0 && C % EPC == 0 && h16) {
    // 16-byte pieces of each (row, type) of the slab
    const int pv = Cs / EPC;
    const FastDiv by_pv(pv);
    for (int q = tid; q < rows * T * pv; q += nt) {
      const int o = by_pv(q);  // o = r T + t
      const int c = EPC * (q - o * pv);
      const int r = by_t(o);
      cp_async(hs + (size_t)r * RS + (o - r * T) * Cs + c,
               hb + (size_t)o * C + c, 16);
    }
  } else {
    for (int q = tid; q < rows * T * cv; q += nt) {
      const int o = by_cv(q);  // o = r T + t
      const int c = (q - o * cv) * VEC;
      const int r = by_t(o);
      stage<VEC>(hs + (size_t)r * RS + (o - r * T) * Cs + c,
                 hb + (size_t)o * C + c);
    }
  }
  for (int q = tid; q < nd * K; q += nt)
    cp_async(nn + q, nn_idx + (size_t)d0 * K + q, 4);
  const float* eb = etype + ((size_t)b * Nd + d0) * K * T;
  const bool et_vec = T % 4 == 0 && (reinterpret_cast<uintptr_t>(eb) & 15) == 0;
  if (ET) {
    // the rows' etype, rounded once per (d, k, t) on its way to shared
    // memory while the slab's copies are in flight
    const int ne = nd * K * T;
    if (et_vec) {
#pragma unroll 4
      for (int q = tid; q < ne / 4; q += nt) {
        float v[4];
        Vec<4>::load(eb + 4 * q, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = rnd<TH>(v[u]);
        *reinterpret_cast<float4*>(ws + 4 * q) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll 4
      for (int q = tid; q < ne; q += nt) ws[q] = rnd<TH>(__ldg(eb + q));
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the messages and their aggregate, one item per (d, vector, lane)
  const int G = 1 << lg;
  const int items = nd * cv * G;
  const int steps = (items + nt - 1) / nt;  // the same in every warp
  const int sx = vec_fast ? cv : 1;         // lane stride between the G lanes
  const bool w_vec = ET ? T % 4 == 0 : et_vec;
  for (int it = 0; it < steps; ++it) {
    const int qq = it * nt + tid;
    const bool live = qq < items;  // whole groups of G lanes: items % G == 0
    const int q = live ? qq : 0;
    int dl, c, g;
    if (vec_fast) {  // q = (dl G + g) cv + vector
      const int o = by_cv(q);
      c = (q - o * cv) * VEC;
      dl = o >> lg;
      g = o & (G - 1);
    } else {         // q = (dl cv + vector) G + g
      const int o = q >> lg;
      g = q & (G - 1);
      dl = by_cv(o);
      c = (o - dl * cv) * VEC;
    }
    // word offsets into the staged slab (32-bit shared-memory addressing)
    const int self_row = 2 * (d0 + dl) * RS + c;
    const int nk = (K - g + G - 1) >> lg;  // this lane's edges, >= 1 (G <= K)
    float acc[VEC] = {}, sm[VEC] = {};
    int am[VEC] = {};
    for (int j0 = 0; j0 < nk; j0 += KC) {
      const int jn = min(KC, nk - j0);
      int nb_row[KC];
      const float* w[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int e = dl * K + g + ((j0 + (j < jn ? j : 0)) << lg);
        nb_row[j] = (2 * nn[e] + 1) * RS + c;
        w[j] = (ET ? ws : eb) + (size_t)e * T;
      }
      float m[KC][VEC];
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i) m[j][i] = 0.f;
      for (int t0 = 0; t0 < T; t0 += 4) {
        float wv[KC][4];
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (j < jn) {
            if (ET && w_vec) {
              Vec<4>::lds(w[j] + t0, wv[j]);
            } else if (ET) {
#pragma unroll
              for (int u = 0; u < 4; ++u)
                wv[j][u] = t0 + u < T ? w[j][t0 + u] : 0.f;
            } else {
              etype_run(w[j], t0, T, w_vec, wv[j]);
#pragma unroll
              for (int u = 0; u < 4; ++u) wv[j][u] = rnd<TH>(wv[j][u]);
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) wv[j][u] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (t0 + u < T) {
            // all of the lane's loads first, so that their latencies
            // overlap; the sums of edges past jn are never used
            const int tc = (t0 + u) * Cs;
            float sv[VEC], hv[KC][VEC];
            Vec<VEC>::lds(hs + self_row + tc, sv);
#pragma unroll
            for (int j = 0; j < KC; ++j) {
              if (j < jn) {
                Vec<VEC>::lds(hs + nb_row[j] + tc, hv[j]);
              } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i) hv[j][i] = 0.f;
              }
            }
#pragma unroll
            for (int j = 0; j < KC; ++j)
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                m[j][i] = fmaf(wv[j][u], sv[i] + hv[j][i], m[j][i]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (j < jn)
          agg_step<AGG, VEC>(m[j], g + ((j0 + j) << lg), j0 + j == 0, gamma,
                             acc, sm, am);
    }
    // the G lanes' aggregates, combined in a fixed butterfly
    for (int off = G / 2; off > 0; off /= 2) {
      const int lane_off = off * sx;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[i], lane_off);
        if (AGG == AGG_MAX) {
          const int ok = __shfl_xor_sync(0xffffffffu, am[i], lane_off);
          if (oa > acc[i] || (oa == acc[i] && ok < am[i])) {
            acc[i] = oa;
            am[i] = ok;
          }
        } else if (AGG == AGG_SOFTMAX) {
          const float os = __shfl_xor_sync(0xffffffffu, sm[i], lane_off);
          const float mx = fmaxf(acc[i], oa);
          sm[i] = sm[i] * expf(gamma * (acc[i] - mx)) +
                  os * expf(gamma * (oa - mx));
          acc[i] = mx;
        } else {
          acc[i] = acc[i] + oa;
        }
      }
    }
    if (!live || g != 0) continue;
    agg_finish<AGG, VEC>(K, gamma, sm, acc);
    const size_t o = ((size_t)b * Nd + d0 + dl) * C + c0 + c;
    Vec<VEC>::store(out + o, acc);
    if (AGG == AGG_MAX && argmax != nullptr) Vec<VEC>::store_u8(argmax + o, am);
    if (AGG == AGG_SOFTMAX && lse != nullptr) Vec<VEC>::store(lse + o, acc);
  }
}

template <int AGG, int VEC, int KC, class TH, bool ET>
int launch_staged(cudaStream_t st, unsigned blocks, int threads, size_t smem,
                  const TH* h, const int32_t* nn_idx, const float* etype,
                  TH* out, uint8_t* argmax, float* lse, int N, int K, int T,
                  int C, int cs, int tiles, int tile_rows, int lg,
                  int vec_fast, float gamma) {
  auto kernel = staged_fwd_kernel<AGG, VEC, KC, TH, ET>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, st>>>(h, nn_idx, etype, out, argmax, lse,
                                        N, K, T, C, cs, tiles, tile_rows, lg,
                                        vec_fast, gamma);
  return (int)cudaGetLastError();
}

template <int VEC, int KC, class TH, bool ET, typename... A>
int dispatch_staged(int aggregator, A... a) {
  switch (aggregator) {
    case AGG_MAX: return launch_staged<AGG_MAX, VEC, KC, TH, ET>(a...);
    case AGG_SUM: return launch_staged<AGG_SUM, VEC, KC, TH, ET>(a...);
    case AGG_MEAN: return launch_staged<AGG_MEAN, VEC, KC, TH, ET>(a...);
    case AGG_SOFTMAX: return launch_staged<AGG_SOFTMAX, VEC, KC, TH, ET>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// KC, the edges a lane carries at once: the lane's edges, rounded up to 1,
// 2 or MAX_KC (3 too in the bf16 design; the arithmetic of the KC slots
// runs for every lane).
template <int VEC, class TH, bool ET, typename... A>
int by_kc(int kc, int aggregator, A... a) {
  if (kc == 1) return dispatch_staged<VEC, 1, TH, ET>(aggregator, a...);
  if (kc == 2) return dispatch_staged<VEC, 2, TH, ET>(aggregator, a...);
  if constexpr (ET) {
    if (kc == 3) return dispatch_staged<VEC, 3, TH, ET>(aggregator, a...);
  }
  return dispatch_staged<VEC, MAX_KC, TH, ET>(aggregator, a...);
}

// --------------------------------------------------------------------------
// the sample route: NO_EXTENSION in the bf16 mode

constexpr int SAMPLE_THREADS = 512;  // most threads a block

// Shared memory of one block of the sample route, in bytes, each region
// 16-byte aligned: the sample's h (N, T, C) bf16 as it lies in device
// memory, its etype (Nd K T) rounded to bf16 and held as f32, and the table
// (Nd K) int32.
__host__ __device__ inline size_t sample_bytes(int N, int Nd, int K, int T,
                                               int C) {
  return pad16((size_t)N * T * C * sizeof(bf16)) +
         4 * pad4((size_t)Nd * K * T) + 4 * pad4((size_t)Nd * K);
}

// Block b takes sample b.  It copies the whole of the sample's h into
// shared memory with 16-byte cp.async, the table likewise, and rounds the
// sample's etype to bf16 once per (d, k, t) into shared memory.  Then one
// item per (row, vector of 8 channels) forms the K messages in the kept
// kernel's order (fmaf over ascending t from 0, then the aggregate over
// ascending k), so out, the argmax and the log-sum-exp are the kept bf16
// kernel's bits.
template <int AGG>
__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_fwd_kernel(const bf16* __restrict__ h,
                  const int32_t* __restrict__ nn_idx,
                  const float* __restrict__ etype, bf16* __restrict__ out,
                  uint8_t* __restrict__ argmax, float* __restrict__ lse,
                  int N, int Nd, int K, int T, int C, float gamma) {
  constexpr int VEC = 8;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int TC = T * C;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* ws = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                       pad16((size_t)N * TC * sizeof(bf16)));
  int* nn = reinterpret_cast<int*>(ws + pad4((size_t)Nd * K * T));

  // 1. stage the sample's h, the table and the rounded etype
  const bf16* hb = h + (size_t)b * N * TC;
  for (int q = tid; q < N * TC / VEC; q += nt)
    cp_async(hs + VEC * q, hb + VEC * q, 16);
  for (int q = tid; q < Nd * K; q += nt) cp_async(nn + q, nn_idx + q, 4);
  const float* eb = etype + (size_t)b * Nd * K * T;
  for (int q = tid; q < Nd * K * T; q += nt) ws[q] = rnd<bf16>(__ldg(eb + q));
  cp_async_wait_all();
  __syncthreads();

  // 2. one item per (row d, vector of channels)
  const int cv = C / VEC;
  const FastDiv by_cv(cv);
  for (int q = tid; q < Nd * cv; q += nt) {
    const int d = by_cv(q);
    const int c = (q - d * cv) * VEC;
    const int* nk = nn + d * K;
    const float* w = ws + d * K * T;
    float acc[VEC], s[VEC];
    int am[VEC];
    for (int k = 0; k < K; ++k) {
      const bf16* hr = hs + nk[k] * TC + c;
      const float* wk = w + k * T;
      float m[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = 0.f;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        float hv[VEC];
        Vec<VEC>::lds(hr + t * C, hv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) m[i] = fmaf(wk[t], hv[i], m[i]);
      }
      agg_step<AGG, VEC>(m, k, k == 0, gamma, acc, s, am);
    }
    agg_finish<AGG, VEC>(K, gamma, s, acc);
    const size_t o = ((size_t)b * Nd + d) * C + c;
    Vec<VEC>::store(out + o, acc);
    if (AGG == AGG_MAX && argmax != nullptr) Vec<VEC>::store_u8(argmax + o, am);
    if (AGG == AGG_SOFTMAX && lse != nullptr) Vec<VEC>::store(lse + o, acc);
  }
}

template <int AGG>
int launch_sample(cudaStream_t st, unsigned blocks, int threads, size_t smem,
                  const bf16* h, const int32_t* nn_idx, const float* etype,
                  bf16* out, uint8_t* argmax, float* lse, int N, int Nd,
                  int K, int T, int C, float gamma) {
  auto kernel = sample_fwd_kernel<AGG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, st>>>(h, nn_idx, etype, out, argmax, lse,
                                        N, Nd, K, T, C, gamma);
  return (int)cudaGetLastError();
}

template <typename... A>
int dispatch_sample(int aggregator, A... a) {
  switch (aggregator) {
    case AGG_MAX: return launch_sample<AGG_MAX>(a...);
    case AGG_SUM: return launch_sample<AGG_SUM>(a...);
    case AGG_MEAN: return launch_sample<AGG_MEAN>(a...);
    case AGG_SOFTMAX: return launch_sample<AGG_SOFTMAX>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The storage type of h and out: bf16 or f32.
template <typename F>
int by_type(int bf16_mode, const void* h, void* out, F&& f) {
  return bf16_mode ? f(static_cast<const bf16*>(h), static_cast<bf16*>(out))
                   : f(static_cast<const float*>(h), static_cast<float*>(out));
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.  `argmax` and `lse` (softmax's f32
// log-sum-exp) may be null; `vec4` asks for the vector path, which needs
// C % 4 == 0 and 16-byte aligned h and out; `bf16` says h and out are bf16
// (the bf16 mode); `ext` selects the DIFF/NEIGHBOR mode, whose h has 2 N
// rows and needs Nd == N.
extern "C" int typed_mp_fwd(const void* h, const int32_t* nn_idx,
                            const float* etype, void* out, uint8_t* argmax,
                            float* lse, int B, int N, int Nd, int K, int T,
                            int C, int aggregator, float gamma, int vec4,
                            int bf16_mode, int ext, void* stream) {
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
  return by_type(bf16_mode, h, out, [&](auto hp, auto op) {
    using TH = std::remove_const_t<std::remove_pointer_t<decltype(hp)>>;
    return vec4 ? by_ext<4, TH>(ext, aggregator, nb, threads_x, rows, s, hp,
                                nn_idx, etype, op, argmax, lse, N, Nd, K, T,
                                C, gamma)
                : by_ext<1, TH>(ext, aggregator, nb, threads_x, rows, s, hp,
                                nn_idx, etype, op, argmax, lse, N, Nd, K, T,
                                C, gamma);
  });
}

// The staged route, DIFF/NEIGHBOR only (h (B, 2 N, T, C), Nd == N): `cs`
// channels per block, a divisor of C whose slab of h, with the table of
// the block's rows (and, in the bf16 design, their etype), fits in a
// block's shared memory.  `vec4` asks for the vector path: C % 4 == 0,
// cs % 4 == 0, 16-byte aligned h, out and lse.  `bf16` and `lse` as for
// typed_mp_fwd.  `design` 0 is the kept design of both modes: from the
// shapes alone it splits the rows into tiles where the (sample, slab)
// blocks would leave most SMs idle (`tiles` must be 0).  `design` 1, the
// bf16 mode's design (ops/fused_mp.py:fwd_bf16_plan), takes `tiles` row
// tiles, stages etype rounded once, and on the vector path runs 8 channels
// a thread where cs % 8 == 0.  Both put G lanes (1, 2, 4 or 8, at most K)
// on each (row, vector), as many as keep one item per thread.
extern "C" int typed_mp_fwd_staged(const void* h, const int32_t* nn_idx,
                                   const float* etype, void* out,
                                   uint8_t* argmax, float* lse, int B, int N,
                                   int Nd, int K, int T, int C,
                                   int aggregator, float gamma, int vec4,
                                   int bf16_mode, int cs, int design,
                                   int tiles, void* stream) {
  const int esz = bf16_mode ? 2 : 4;
  if (B <= 0 || N <= 0 || Nd != N || K <= 0 || K > 255 || T <= 0 || C <= 0 ||
      cs <= 0 || C % cs != 0 || (vec4 && (C % 4 != 0 || cs % 4 != 0)) ||
      design < 0 || design > 1 || (design == 0 && tiles != 0) ||
      (design == 1 && (!bf16_mode || tiles < 1 || tiles > Nd)) ||
      (design == 0 &&
       fwd_staged_bytes(2 * N, Nd, K, T, cs, esz, false) > SMEM_PER_BLOCK))
    return (int)cudaErrorInvalidValue;
  const long long bs = (long long)B * (C / cs);  // (sample, slab) blocks
  if (design == 0)
    tiles = 2 * bs >= SMS ? 1
                          : (int)std::min<long long>(Nd, (SMS + bs - 1) / bs);
  const int tile_rows = (Nd + tiles - 1) / tiles;
  tiles = (Nd + tile_rows - 1) / tile_rows;
  // lanes G = 1 << lg on each (row, vector): as many, up to 8 and at most
  // `most`, as keep one item per thread
  auto lanes = [&](int cv, int most) {
    int lg = 0;
    while (lg < 3 && (2 << lg) <= most &&
           (long long)tile_rows * cv * (2 << lg) <= STAGED_THREADS)
      ++lg;
    return lg;
  };
  // the bf16 design takes 8 channels a thread where cs % 8 == 0, with
  // lanes of at least two edges each, unless 4 channels (lanes of one edge
  // or more) make more items
  const int most8 = std::max(1, K / 2);
  int vec = vec4 ? 4 : 1;
  if (design == 1 && vec4 && cs % 8 == 0 &&
      ((cs / 8) << lanes(cs / 8, most8)) >= ((cs / 4) << lanes(cs / 4, K)))
    vec = 8;
  const int cv = cs / vec;
  const int lg = lanes(cv, vec == 8 ? most8 : K);
  const int vec_fast = (cv & (cv - 1)) == 0 && (cv << lg) <= 32;
  const int lane_edges = (K + (1 << lg) - 1) >> lg;
  // the bf16 design carries up to MAX_KC edges exactly, the kept one 1, 2
  // or MAX_KC
  const int kc = lane_edges <= (design == 1 ? MAX_KC : 2) ? lane_edges
                                                         : MAX_KC;
  const long long items = (long long)tile_rows * cv * (1 << lg);
  const int threads = (int)std::max<long long>(
      128, std::min<long long>(STAGED_THREADS, (items + 31) / 32 * 32));
  const long long blocks = bs * tiles;
  const size_t smem =
      fwd_staged_bytes(2 * N, tile_rows, K, T, cs, esz, design == 1);
  if (blocks > INT_MAX || smem > SMEM_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
  return by_type(bf16_mode, h, out, [&](auto hp, auto op) {
    using TH = std::remove_const_t<std::remove_pointer_t<decltype(hp)>>;
    if constexpr (std::is_same<TH, bf16>::value) {
      if (design == 1) {
        if (vec == 8)
          return by_kc<8, TH, true>(kc, aggregator, s, nb, threads, smem, hp,
                                    nn_idx, etype, op, argmax, lse, N, K, T,
                                    C, cs, tiles, tile_rows, lg, vec_fast,
                                    gamma);
        return vec == 4
                   ? by_kc<4, TH, true>(kc, aggregator, s, nb, threads, smem,
                                        hp, nn_idx, etype, op, argmax, lse,
                                        N, K, T, C, cs, tiles, tile_rows, lg,
                                        vec_fast, gamma)
                   : by_kc<1, TH, true>(kc, aggregator, s, nb, threads, smem,
                                        hp, nn_idx, etype, op, argmax, lse,
                                        N, K, T, C, cs, tiles, tile_rows, lg,
                                        vec_fast, gamma);
      }
    }
    return vec4 ? by_kc<4, TH, false>(kc, aggregator, s, nb, threads, smem,
                                      hp, nn_idx, etype, op, argmax, lse, N,
                                      K, T, C, cs, tiles, tile_rows, lg,
                                      vec_fast, gamma)
                : by_kc<1, TH, false>(kc, aggregator, s, nb, threads, smem,
                                      hp, nn_idx, etype, op, argmax, lse, N,
                                      K, T, C, cs, tiles, tile_rows, lg,
                                      vec_fast, gamma);
  });
}

// The sample route, NO_EXTENSION in the bf16 mode (h (B, N, T, C) bf16,
// out bf16): one block per sample, the whole of the sample's h in shared
// memory, 8 channels a thread.  It takes C % 8 == 0 and 16-byte aligned h,
// out and lse; ops/fused_mp.py:fwd_sample plans it only where the samples
// give at least every second SM a block.  `argmax` and `lse` as for
// typed_mp_fwd.
extern "C" int typed_mp_fwd_sample(const void* h, const int32_t* nn_idx,
                                   const float* etype, void* out,
                                   uint8_t* argmax, float* lse, int B, int N,
                                   int Nd, int K, int T, int C,
                                   int aggregator, float gamma,
                                   void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(lse)) & 15) == 0;
  if (B <= 0 || N <= 0 || Nd <= 0 || K <= 0 || K > 255 || T <= 0 || C <= 0 ||
      C % 8 != 0 || !aligned ||
      sample_bytes(N, Nd, K, T, C) > SMEM_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  // as few threads as run the items in the same number of steps
  const long long items = (long long)Nd * (C / 8);
  const long long steps = (items + SAMPLE_THREADS - 1) / SAMPLE_THREADS;
  const int threads = (int)std::max<long long>(
      32, ((items + steps - 1) / steps + 31) / 32 * 32);
  const size_t smem = sample_bytes(N, Nd, K, T, C);
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* hp = static_cast<const bf16*>(h);
  bf16* op = static_cast<bf16*>(out);
  return dispatch_sample(aggregator, s, (unsigned)B, threads, smem, hp,
                         nn_idx, etype, op, argmax, lse, N, Nd, K, T, C,
                         gamma);
}
