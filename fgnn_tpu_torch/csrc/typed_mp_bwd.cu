// Typed-edge gather + edge-type mix + K-aggregation, backward (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel fgnn_tpu/ops/fused_mp.py:_bwd_kernel in
// both of its modes, NO_EXTENSION and DIFF/NEIGHBOR (`ext`), the backward
// of typed_mp_fwd.cu.  From the cotangent g (B, Nd, C) of out, the per-edge
// cotangent
//
//   dm[b, d, k, c] = g[b, d, c] * [argmax[b, d, c] == k]      max (first win)
//                    g[b, d, c]                              sum
//                    g[b, d, c] / K                          mean
//                    g[b, d, c] * exp(g (m_k - out[b, d, c])) softmax
//
// (softmax recomputes m_k in the forward's order, the row sum first and
// then the type mix in ascending t with fmaf, and takes the saved out as the
// log-sum-exp), then, with hg[b, d, k] the row sum the edge (d, k) read in
// the forward (h[b, nn_idx[d, k]] for NO_EXTENSION, h[b, 2 d] +
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
// (ops/typed_mp.py:GatherTable builds both forms).
//
// What bounds it on the H100: bytes.  At the LDPC f2v shape (B=256,
// N_src=48, Nd=96, K=3, T=4, C=64) it must read g 6.3 MB, argmax 1.6 MB,
// h 12.6 MB and etype 1.2 MB and write dh 12.6 MB and d_etype 1.2 MB: about
// 35 MB, or 11 us at 3.35 TB/s, against 75 MFLOP.  At the synthetic hop
// conv (B=32, N=Nd=60, K=9, T=16, C=64, an extension) it moves h and dh
// 15.7 MB each and etype and d_etype 1.1 MB each: 34 MB, or 10 us, against
// 0.1 GFLOP.  That is 2 to 4 FLOP per byte, far below the 20 FLOP per byte
// where f32 arithmetic would bound it, so the tensor cores would buy
// nothing; TF32 would also break the 1e-5 agreement with the plain version.
//
// Two routes, each behind its own C entry point; ops/fused_mp.py:bwd_slab
// picks one from the shapes alone, before the launch:
//
// * typed_mp_bwd_staged: staged_bwd_kernel, the main route.  One block of
//   512 threads per (sample b, slab of Cs channels) holds what the sample
//   needs for its slab in shared memory: the graph table is shared across
//   the batch and dh is independent across channels.  The first kernels of
//   the port (below) lost their time in four ways, and the staging answers
//   each:
//   1. d_etype_kernel ran a row's K edges one after another, each waiting on
//      nn_idx, re-read the gathered h row from L2 once per type and made T
//      warp reductions: at LDPC f2v 75 MB of L2 reads against 12.6 MB of h.
//      Here the block copies its slab of h (R N_src, T, Cs), the sample's
//      etype and both tables into shared memory once, with cp.async, so h
//      crosses device memory once; then G lanes (1, 2, 4 or 8, as many as
//      the block has threads for) per (edge, run of 4 types) sum over the
//      slab's channels, each lane starting at a staggered channel so that
//      the lanes of a wavefront hit distinct banks, and add their sums in a
//      fixed butterfly.
//   2. dh_kernel re-walked each row's in-edges T / 4 times.  Here one thread
//      per (row, run of 4 types, 4 channels) walks them once, reading the
//      edge ids from shared memory.
//   3. Softmax recomputed m_k wherever dm was needed, up to 9 times per edge.
//      Here softmax builds dm once per (edge, channel) into shared memory
//      from the staged rows.  Max, sum and mean stage g and the argmax (5
//      bytes a channel, against 4 K for dm) and build dm where they read it,
//      so that two LDPC blocks fit on an SM.
//   4. At C = 2 the first kernels ran a tenth of the card, one thread per
//      two-lane row recomputing messages.  Here the whole sample sits in
//      shared memory, h and etype rows padded so that rows start on
//      different banks, and the block makes a few passes over it.
//   The phases were bound by instruction issue, not by memory (per-block
//   timestamps on the H100, PERF.md): every index is split with one
//   multiply (FastDiv), and each thread keeps 4 types x 4 channels of sums,
//   so that a load of dm or of a row of h feeds 16 FMAs.  With Cs < C the
//   S = C / Cs blocks of a sample write partial sums of d_etype to scratch
//   that the wrapper allocates, and sum_slabs adds them in slab order.  No
//   atomics anywhere: two launches give the same bits.  Shared memory per
//   block: at most 227 KB (staged_bytes, ops/fused_mp.py:staged_bytes).
// * typed_mp_bwd: d_etype_kernel and dh_kernel, the first kernels of the
//   port, kept for shapes whose narrowest slab does not fit in shared
//   memory (N_src in the thousands; no model of the repository), and as the
//   baseline the staged kernel is timed against (chip_smoke.py).  They read
//   h rows from L2 by nn_idx, rebuild dm in registers wherever it is
//   needed, and walk the transposed table in T_CHUNK passes.
//
// The staged route has an f32 and a bf16 mode (the template argument TH,
// the storage type of h, g and dh), as the TPU kernel's mm_dtype.  The bf16
// mode reads bf16 h and g; for max, sum and mean dm is bf16 (g, or g / K
// rounded to bf16 for mean), for softmax f32 (g times the weight, from the
// forward's f32 log-sum-exp `out`); etype is rounded to bf16 where it is
// read; every product dm hg (d_etype) and dm etype (dh) is rounded to bf16
// before its f32 sum, as the TPU kernel rounds its matmuls' operands; d_etype
// stays f32 and dh is rounded once to bf16 on the store.  The gathered row
// sum hg of the extensions stays f32 (the TPU kernel's bf16 store of it for
// softmax is a VMEM tiling choice).  The staged slab of h and g halve.  The
// kept route is f32 only (the wrapper refuses a bf16 h there).
//
// The bf16 mode has two sets of products (`packed`, a template argument
// PACK of staged_bwd_kernel):
// * the packed route (PACK), planned for every bf16 launch of max, sum or
//   mean on the vector path (C and the slab a multiple of 4).  The
//   staged phases are bound by instruction issue (above), and the scalar
//   bf16 product cost four instructions where f32 fuses one FMA: an f32
//   multiply, a round to bf16, a widening, an add, after widening both
//   operands.  Both operands of a product are bf16 wherever dm is (max,
//   sum, mean) and, for d_etype, wherever hg is a staged row (NO_EXTENSION),
//   so one mul.rn.bf16x2 (mul_rnd2) rounds two products at once, with the
//   bits of the scalar rounding (the product of two bf16 values is exact in
//   f32 in f32's normal range, and rounds alike below it), and only the two
//   f32 adds remain.  The pairs are read from shared memory as they lie,
//   never widened first.  Whole rows of h and g are copied in 16 bytes, and
//   mean stages g / K once.  Every sum keeps the scalar route's order: the
//   same bits.  At LDPC f2v C=64 on the H100 (PERF.md) it is still slower
//   than f32: in bf16 a product costs half a multiply, a widening and an
//   add where f32 fuses one FMA.
// * the kept route (PACK false, `packed=False` in the wrapper): the scalar
//   products, as the bf16 mode first had them.  Softmax (f32 dm) and the
//   scalar path (C or the slab not a multiple of 4) run it on either
//   setting, and the wrapper counts them there.
//
// The DIFF/NEIGHBOR mode in bf16 has a design of its own (typed_mp_bwd_ext,
// ext_bwd_kernel, planned by ops/fused_mp.py:bwd_ext_plan), for max, sum
// and mean on 16-byte vectors; the staged kernel with the f32 mode's plan
// and the packed products stays reachable (kept=True).  That kept route
// ran the f32 design on a bf16 slab: its plan took the f32 slab (4 slabs of
// 16 channels at the hop table, 128 lone blocks), each of a sample's 4
// blocks staged its f32 etype and rounded it at every use, its d_etype
// phase formed scalar products, and a softmax conv at C=2 ran 32 blocks.
// The design (where its launch goes, phase by phase: python -m
// fgnn_tpu_torch.utils.phases; PERF.md):
// * the whole of C in a block where it fits, in tiles of destination
//   rows, one block an SM (bwd_ext_tiles): at the hop tables 4 tiles of
//   15 rows a sample, and no partial sums of d_etype, so no sum_slabs (a
//   launch of its own);
// * of h only what its tile reads: the N neighbour rows and the tile's
//   self rows, staged after what dh needs, so that they arrive while dh
//   runs (dh reads no h);
// * etype and mean's g / K rounded once in shared memory;
// * dh: under max a self row's single product per (t, c), in warps of
//   self rows apart from warps of neighbour rows; the neighbour rows keep
//   the packed products in the table's order: dh has the kept route's bits;
// * d_etype: 8 channels a thread, the self row and g held over d's K
//   edges, products rounded two at a time (rnd2) and summed in a fixed
//   order (other bits than the kept route's, within the bf16 checks).
// Softmax and C % 8 != 0 run the staged kernel in tiles of rows
// (bwd_ext_tiles, the wrapper's `tiles`), which fills the SMs at C=2 with
// the same sums of dh; d_etype's lanes follow the tile.
//
// Each route launches on the caller's stream, allocates nothing and never
// synchronises; the wrapper (fgnn_tpu_torch/ops/fused_mp.py) checks the
// arguments, picks the route and allocates the outputs.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "typed_mp_common.cuh"

namespace {

constexpr int MAX_T = 16;   // partial sums kept in registers
constexpr int T_CHUNK = 4;  // types per pass of dh_kernel over the in-edges
constexpr int THREADS = 256;
constexpr int MAX_SLABS = 8;  // slabs a sample, partial sums added

// --------------------------------------------------------------------------
// the staged route

constexpr int STAGED_THREADS = 512;

// Row stride of the staged etype, in words: a multiple of 4, so that a
// run of 4 types loads as one vector; softmax reads one type of many edges
// at once, and 4 more words spread those over the banks.
__host__ __device__ inline int et_stride(int T, bool softmax) {
  return (int)pad4(T) + (softmax ? 4 : 0);
}

// Shared memory of one block, in bytes, each region 16-byte aligned: hs,
// the slab of h, rows of row_stride elements of esz bytes; the cotangent:
// softmax keeps f32 dm (E, Cs), the others g (Nd, Cs) in h's type and, as
// bytes, the argmax (Nd, Cs), and build dm where they read it; et, the
// sample's f32 etype, rows of et_stride words; nn (E), the gather table; sp
// (rows + 1) and se (at most 2 E), the transposed table.
inline size_t staged_bytes(int rows, int Nd, int K, int T, int cs,
                           bool softmax, int esz) {
  const size_t E = (size_t)Nd * K;
  const size_t cot = softmax ? 4 * pad4(E * cs)
                             : pad16((size_t)Nd * cs * esz) +
                                   pad16((size_t)Nd * cs);
  return pad16((size_t)rows * row_stride(T, cs, esz) * esz) + cot +
         4 * (pad4(E * et_stride(T, softmax)) + pad4(E) +
              pad4((size_t)rows + 1) + pad4(2 * E));
}

// dm[e, c..c+VEC-1] for max, sum and mean, from the staged g and argmax of
// e's destination d (e = d K + k); mean's g / K in the mode's type.
template <int AGG, int VEC, class TH>
__device__ __forceinline__ void staged_dm(const TH* gs, const uint8_t* as,
                                          int d, int k, int Cs, int c,
                                          float inv_k, float* v) {
  Vec<VEC>::lds(gs + (size_t)d * Cs + c, v);
  if (AGG == AGG_MAX) {
    uint8_t a[VEC];
    if (VEC == 4) {
      *reinterpret_cast<uchar4*>(a) =
          *reinterpret_cast<const uchar4*>(as + (size_t)d * Cs + c);
    } else {
      a[0] = as[(size_t)d * Cs + c];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = a[i] == k ? v[i] : 0.f;
  } else if (AGG == AGG_MEAN) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = rnd<TH>(v[i] * inv_k);
  }
}

// The packed route's dm[e, c..c+3] for max, sum and mean as two bf16
// pairs, straight from the staged g (mean's g is staged as g / K) and, for
// max, zeroed where the argmax (4 bytes) is not e's slot k: the pairs that
// staged_dm's values round to, never widened.
template <int AGG>
__device__ __forceinline__ uint2 staged_dm2(const bf16* gs, const uint8_t* as,
                                            int d, int k, int Cs, int c) {
  uint2 v = *reinterpret_cast<const uint2*>(gs + (size_t)d * Cs + c);
  if (AGG != AGG_MAX) return v;
  const unsigned a =
      *reinterpret_cast<const unsigned*>(as + (size_t)d * Cs + c);
  const unsigned eq = __vcmpeq4(a, 0x01010101u * (unsigned)k);  // 0xff: ==
  v.x &= __byte_perm(eq, 0, 0x1100);  // channels c, c + 1
  v.y &= __byte_perm(eq, 0, 0x3322);  // channels c + 2, c + 3
  return v;
}

__device__ __forceinline__ __nv_bfloat162 pair(unsigned w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

// Block blockIdx.x = (b S + s) tiles + tile takes sample b's channels
// [s Cs, (s+1) Cs) for the destinations d of its tile (the extensions' rows
// 2 d and 2 d + 1 of dh and the edges of d in d_etype; tiles > 1 for the
// extensions only); with tiles = 1, as every kept route runs, all of them.
// It stages the whole sample either way.  The types are handled in runs of
// 4: a thread of dh or d_etype keeps 4
// types x VEC channels of sums in registers, so each load of dm or of a
// row of h feeds 4 VEC FMAs.  PACK (the bf16 mode's packed route: VEC = 4,
// max, sum or mean) forms the bf16-rounded products of the dh phase, and of
// the d_etype phase for NO_EXTENSION, two channels at a time from bf16
// pairs (mul_rnd2), in the same order of sums as the scalar bf16 mode, so
// with the same bits; it copies whole rows of h and g in 16 bytes, and
// stages mean's g as g / K.
template <int AGG, int VEC, bool EXT, class TH, bool PACK>
__global__ void __launch_bounds__(STAGED_THREADS)
staged_bwd_kernel(const TH* __restrict__ g,
                  const uint8_t* __restrict__ argmax,
                  const TH* __restrict__ h,
                  const int32_t* __restrict__ nn_idx,
                  const int32_t* __restrict__ src_ptr,
                  const int32_t* __restrict__ src_edge,
                  const float* __restrict__ etype,
                  const float* __restrict__ out, TH* __restrict__ dh,
                  float* __restrict__ d_etype, float* __restrict__ part,
                  int N, int Nd, int K, int T, int C, int Cs, int tiles,
                  float gamma) {
  constexpr int R = EXT ? 2 : 1;
  constexpr bool SOFTMAX = AGG == AGG_SOFTMAX;
  constexpr int ESZ = (int)sizeof(TH);
  extern __shared__ __align__(16) float smem[];
  const int S = C / Cs;
  const int bs = blockIdx.x / tiles;
  const int b = bs / S;
  const int s = bs - b * S;
  const int c0 = s * Cs;
  const int rows = R * N;
  const int E = Nd * K;
  // the tile's destinations d0 .. d0 + nd (the extensions' rows 2 d and
  // 2 d + 1 of dh and the edges of d in d_etype), all of them for tiles = 1
  const int tile_rows = (Nd + tiles - 1) / tiles;
  const int d0 = (blockIdx.x - bs * tiles) * tile_rows;
  const int nd = min(tile_rows, Nd - d0);
  const int r0 = EXT ? 2 * d0 : 0, nr = EXT ? 2 * nd : rows;
  const int cv = Cs / VEC;               // vectors per slab row
  const int RS = row_stride(T, Cs, ESZ);
  const int ET = et_stride(T, SOFTMAX);
  const int runs = (T + 3) / 4;          // runs of 4 types
  const int tid = threadIdx.x;
  const int nt = STAGED_THREADS;
  const FastDiv by_cv(cv), by_t(T), by_k(K), by_runs(runs), by_e(nd * K);
  const float inv_k = 1.f / (float)K;
  // the packed route stages mean's g as g / K: then dm is g, as for sum
  constexpr int DM_AGG = PACK && AGG == AGG_MEAN ? AGG_SUM : AGG;
  TH* hs = reinterpret_cast<TH*>(smem);
  char* cot = reinterpret_cast<char*>(smem) + pad16((size_t)rows * RS * ESZ);
  float* dm = reinterpret_cast<float*>(cot);  // softmax
  TH* gs = reinterpret_cast<TH*>(cot);        // max, sum, mean
  uint8_t* as = reinterpret_cast<uint8_t*>(cot) +
                pad16((size_t)Nd * Cs * ESZ);
  float* et = reinterpret_cast<float*>(
      cot + (SOFTMAX ? 4 * pad4((size_t)E * Cs)
                     : pad16((size_t)Nd * Cs * ESZ) + pad16((size_t)Nd * Cs)));
  int* nn = reinterpret_cast<int*>(et + pad4((size_t)E * ET));
  int* sp = nn + pad4(E);
  int* se = sp + pad4((size_t)rows + 1);

  // 1. stage the slab of h, the sample's etype and the table, and for max,
  // sum and mean the slab of g and of the argmax
  const TH* hb = h + (size_t)b * rows * T * C + c0;
  if (PACK && Cs == C && T * C % 8 == 0 && RS % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(hb) & 15) == 0) {
    // the packed route's whole rows: 16-byte copies
    const int q8 = T * C / 8;
    const FastDiv by_q8(q8);
    for (int q = tid; q < rows * q8; q += nt) {
      const int r = by_q8(q);
      const int o = 8 * (q - r * q8);
      cp_async(hs + (size_t)r * RS + o, hb + (size_t)r * T * C + o, 16);
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
  const float* eb = etype + (size_t)b * E * T;
  if (T % 4 == 0 && (reinterpret_cast<uintptr_t>(eb) & 15) == 0) {
    for (int q = tid; q < E * T / 4; q += nt) {
      const int e = by_runs(q);  // T / 4 == runs
      cp_async(et + (size_t)e * ET + 4 * (q - e * runs), eb + 4 * (size_t)q,
               16);
    }
  } else {
    for (int q = tid; q < E * T; q += nt) {
      const int e = by_t(q);
      cp_async(et + (size_t)e * ET + (q - e * T), eb + q, 4);
    }
  }
  for (int q = tid; q < E; q += nt) cp_async(nn + q, nn_idx + q, 4);
  for (int q = tid; q <= rows; q += nt) cp_async(sp + q, src_ptr + q, 4);
  for (int q = tid; q < R * E; q += nt) cp_async(se + q, src_edge + q, 4);
  if (!SOFTMAX) {
    const size_t g0 = (size_t)b * Nd * C + c0;
    const bool whole = PACK && Cs == C && Nd * C % 8 == 0 &&
                       (reinterpret_cast<uintptr_t>(g + g0) & 15) == 0;
    if (whole)  // the packed route's whole rows of g: 16-byte copies
      for (int q = tid; q < Nd * C / 8; q += nt)
        cp_async(gs + 8 * q, g + g0 + 8 * q, 16);
    for (int q = tid; q < Nd * cv; q += nt) {
      const int d = by_cv(q);
      const int c = (q - d * cv) * VEC;
      if (!whole)
        stage<VEC>(gs + (size_t)d * Cs + c, g + g0 + (size_t)d * C + c);
      if (AGG == AGG_MAX) {
        uint8_t* a = as + (size_t)d * Cs + c;
        if (VEC == 4)
          cp_async(a, argmax + g0 + (size_t)d * C + c, 4);
        else
          *a = argmax[g0 + (size_t)d * C + c];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (PACK && AGG == AGG_MEAN) {  // g / K in bf16, as staged_dm rounds it
    for (int q = tid; q < Nd * Cs; q += nt)
      gs[q] = from_f32<TH>(to_f32(gs[q]) * inv_k);
    __syncthreads();
  }

  // 2. softmax: dm once per (edge, vector), with m_k recomputed from the
  // staged rows in typed_mp_fwd.cu's order
  if (SOFTMAX) {
    for (int q = tid; q < E * cv; q += nt) {
      const int e = by_cv(q);
      const int c = (q - e * cv) * VEC;
      const int d = by_k(e);
      const size_t off = ((size_t)b * Nd + d) * C + c0 + c;
      const TH* hn = hs + (size_t)(nn[e] * R + R - 1) * RS + c;
      const TH* hf = hs + (size_t)(2 * d) * RS + c;  // EXT only
      const float* w = et + (size_t)e * ET;
      float gv[VEC], o[VEC], m[VEC];
      Vec<VEC>::load(g + off, gv);
      Vec<VEC>::load(out + off, o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = 0.f;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        float hv[VEC];
        Vec<VEC>::lds(hn + (size_t)t * Cs, hv);
        if (EXT) {
          float sv[VEC];
          Vec<VEC>::lds(hf + (size_t)t * Cs, sv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) hv[i] = sv[i] + hv[i];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) m[i] = fmaf(rnd<TH>(w[t]), hv[i], m[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        gv[i] = gv[i] * expf(gamma * (m[i] - o[i]));
      Vec<VEC>::store(dm + (size_t)e * Cs + c, gv);
    }
    __syncthreads();
  }

  // 3. dh: one thread per (row, run of 4 types, vector of channels) walks
  // the row's in-edges once, in the table's order.  The et rows are padded
  // to a multiple of 4 words, so each edge's run loads as one vector (sums
  // past T are never stored).
  TH* dhb = dh + (size_t)b * rows * T * C + c0;
  for (int q = tid; q < nr * runs * cv; q += nt) {
    const int o = by_cv(q);  // o = (r - r0) runs + run
    const int c = (q - o * cv) * VEC;
    const int rl = by_runs(o);
    const int r = r0 + rl;
    const int t0 = (o - rl * runs) * 4;
    float acc[4][VEC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
    const int p1 = sp[r + 1];
    for (int p = sp[r]; p < p1; p += 4) {
      int ev[4];  // four edge ids in flight at once
#pragma unroll
      for (int u = 0; u < 4; ++u) ev[u] = p + u < p1 ? se[p + u] : -1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (ev[u] < 0) break;
        if constexpr (PACK) {
          const int d = by_k(ev[u]);
          const uint2 v = staged_dm2<AGG>(gs, as, d, ev[u] - d * K, Cs, c);
          float w[4];
          Vec<4>::lds(et + (size_t)ev[u] * ET + t0, w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 a = mul_rnd2(pair(v.x), w[i]);
            const float2 b2 = mul_rnd2(pair(v.y), w[i]);
            acc[i][0] = acc[i][0] + a.x;
            acc[i][1] = acc[i][1] + a.y;
            acc[i][2] = acc[i][2] + b2.x;
            acc[i][3] = acc[i][3] + b2.y;
          }
          continue;
        }
        float v[VEC], w[4];
        if (SOFTMAX) {
          Vec<VEC>::lds(dm + (size_t)ev[u] * Cs + c, v);
        } else {
          const int d = by_k(ev[u]);
          staged_dm<DM_AGG, VEC>(gs, as, d, ev[u] - d * K, Cs, c, inv_k, v);
        }
        Vec<4>::lds(et + (size_t)ev[u] * ET + t0, w);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = rnd<TH>(w[i]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[i][j] = mac<TH>(v[j], w[i], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + i < T)
        Vec<VEC>::store(dhb + ((size_t)r * T + t0 + i) * C + c, acc[i]);
  }

  // 4. d_etype: G lanes per (run of 4 types, edge), edges fastest, where
  // there are too few of those to fill the block.  Each lane sums over its
  // share of the slab's vectors in VEC independent partial sums, starting
  // at staggered vectors so that the lanes of a wavefront hit distinct
  // banks; the G lanes then add their sums in a fixed butterfly.  With
  // S > 1 they are the slab's partial sums, which sum_slabs adds.
  float* dst = S > 1 ? part + (size_t)bs * E * T
                     : d_etype + (size_t)b * E * T;
  const int items = runs * nd * K;
  int lg = 0;  // G = 1 << lg lanes per item, a power of two <= 8
  while (lg < 3 && cv % (2 << lg) == 0 && items * (2 << lg) <= nt) ++lg;
  const int G = 1 << lg;
  const int per_lane = cv >> lg;  // vectors per lane
  const int steps = (items * G + nt - 1) / nt;  // the same in every warp
  for (int it = 0; it < steps; ++it) {
    const int qq = it * nt + tid;
    const bool live = qq < items * G;
    const int q = live ? qq >> lg : 0;
    const int gl = qq & (G - 1);
    const int run = by_e(q);
    const int e = d0 * K + q - run * nd * K;
    const int d = by_k(e);
    const int t0 = run * 4;
    const TH* hn = hs + (size_t)(nn[e] * R + R - 1) * RS + t0 * Cs;
    const TH* hf = hs + (size_t)(2 * d) * RS + t0 * Cs;  // EXT only
    float acc[4][VEC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
    int m = (q & (VEC == 4 ? 7 : 31)) % per_lane;
    for (int n = 0; n < per_lane; ++n) {
      const int u = (gl + G * m) * VEC;
      if constexpr (PACK && !EXT) {
        const uint2 x = staged_dm2<AGG>(gs, as, d, e - d * K, Cs, u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (t0 + i < T) {
            const uint2 y = *reinterpret_cast<const uint2*>(hn + i * Cs + u);
            const float2 a = mul_rnd2(pair(x.x), pair(y.x));
            const float2 b2 = mul_rnd2(pair(x.y), pair(y.y));
            acc[i][0] = acc[i][0] + a.x;
            acc[i][1] = acc[i][1] + a.y;
            acc[i][2] = acc[i][2] + b2.x;
            acc[i][3] = acc[i][3] + b2.y;
          }
        }
        if (++m == per_lane) m = 0;
        continue;
      }
      float x[VEC];
      if (SOFTMAX)
        Vec<VEC>::lds(dm + (size_t)e * Cs + u, x);
      else
        staged_dm<DM_AGG, VEC>(gs, as, d, e - d * K, Cs, u, inv_k, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (t0 + i < T) {
          float y[VEC];
          Vec<VEC>::lds(hn + i * Cs + u, y);
          if (EXT) {
            float z[VEC];
            Vec<VEC>::lds(hf + i * Cs + u, z);
#pragma unroll
            for (int j = 0; j < VEC; ++j) y[j] = z[j] + y[j];
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[i][j] = mac<TH>(x[j], y[j], acc[i][j]);
        }
      }
      if (++m == per_lane) m = 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = VEC == 4 ? (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3])
                         : acc[i][0];
      for (int off = G / 2; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (live && gl == 0 && t0 + i < T) dst[(size_t)e * T + t0 + i] = v;
    }
  }
}

// --------------------------------------------------------------------------
// the bf16 DIFF/NEIGHBOR design (typed_mp_bwd_ext): max, sum and mean on
// the vector path, 8 channels a thread

constexpr int EXT_THREADS = 512;

// The bf16 pairs v of g (or of g / K) at 8 channels, as four words; for
// max zeroed where their argmax a (8 bytes) is not slot k: the pairs
// staged_dm2 gives, 8 channels at a time.
template <int AGG>
__device__ __forceinline__ uint4 ext_mask(uint4 v, uint2 a, int k) {
  if (AGG != AGG_MAX) return v;
  const unsigned kk = 0x01010101u * (unsigned)k;
  const unsigned e0 = __vcmpeq4(a.x, kk), e1 = __vcmpeq4(a.y, kk);
  v.x &= __byte_perm(e0, 0, 0x1100);
  v.y &= __byte_perm(e0, 0, 0x3322);
  v.z &= __byte_perm(e1, 0, 0x1100);
  v.w &= __byte_perm(e1, 0, 0x3322);
  return v;
}

// ext_mask of row d's g and argmax at channels c..c+7 of the slab
template <int AGG>
__device__ __forceinline__ uint4 ext_dm(const bf16* gs, const uint8_t* as,
                                        int d, int k, int Cs, int c) {
  const uint4 v = *reinterpret_cast<const uint4*>(gs + (size_t)d * Cs + c);
  if (AGG != AGG_MAX) return v;
  return ext_mask<AGG>(
      v, *reinterpret_cast<const uint2*>(as + (size_t)d * Cs + c), k);
}

// Block blockIdx.x = (b S + s) tiles + tile takes sample b's channels
// [s Cs, (s+1) Cs) (Cs % 8 == 0) for the destination rows d of its tile:
// the rows 2 d and 2 d + 1 of dh and the edges of d in d_etype.  It stages
// what staged_bwd_kernel stages for the whole sample (g and the argmax,
// etype, both tables), with 16-byte copies of every slab row, and rounds
// etype to bf16 once per (e, t) and mean's g / K once, in
// place; of h it stages the N neighbour rows, which the tile's edges read,
// and the tile's own self rows.  Then:
// * dh: one item per (row, run of 4 types, 8 channels).  Under max a self
//   row 2 d has one non-zero product per (t, c), g[d, c] times the etype
//   of the edge (d, argmax[d, c]): the item forms that product alone and
//   adds it to +0, which gives the bits of the kept route's sum over the K
//   edges (every other term is a zero product, and acc + 0 is acc for a
//   finite acc; +0 + -0 is +0).  Every other row walks its in-edges in the
//   table's order with the packed products (mul_rnd2) of the kept route:
//   the same bits.
// * d_etype: one item per (d, run of 4 types, 8 channels), the self row's
//   32 values held in registers over d's K edges; each edge's 32 products
//   dm hg are formed in f32 and rounded two at a time (rnd2), summed over
//   the item's channels in ascending order, then over the slab's items in
//   a fixed butterfly; the S slabs' partial sums are added by sum_slabs.
template <int AGG>
__global__ void __launch_bounds__(EXT_THREADS)
ext_bwd_kernel(const bf16* __restrict__ g, const uint8_t* __restrict__ argmax,
               const bf16* __restrict__ h, const int32_t* __restrict__ nn_idx,
               const int32_t* __restrict__ src_ptr,
               const int32_t* __restrict__ src_edge,
               const float* __restrict__ etype, bf16* __restrict__ dh,
               float* __restrict__ d_etype, float* __restrict__ part, int N,
               int K, int T, int C, int Cs, int tiles) {
  constexpr int VEC = 8;
  extern __shared__ __align__(16) float smem[];
  const int Nd = N;
  const int S = C / Cs;
  const int bs = blockIdx.x / tiles;
  const int tile = blockIdx.x - bs * tiles;
  const int b = bs / S;
  const int s = bs - b * S;
  const int c0 = s * Cs;
  const int tile_rows = (Nd + tiles - 1) / tiles;
  const int d0 = tile * tile_rows;
  const int nd = min(tile_rows, Nd - d0);
  const int rows = 2 * N;
  const int E = Nd * K;
  const int cv = Cs / VEC;  // vectors per slab row, a power of two
  const int RS = row_stride(T, Cs, 2);
  const int ET = et_stride(T, false);
  const int runs = (T + 3) / 4;
  const int tid = threadIdx.x;
  const int nt = EXT_THREADS;
  const FastDiv by_cv(cv), by_t(T), by_k(K), by_runs(runs);
  // the slab of h: the N neighbour rows 2 n + 1 in slots n, then the
  // tile's self rows 2 d in slots N + d - d0
  bf16* hs = reinterpret_cast<bf16*>(smem);
  char* cot = reinterpret_cast<char*>(smem) +
              pad16((size_t)(N + tile_rows) * RS * 2);
  bf16* gs = reinterpret_cast<bf16*>(cot);
  uint8_t* as = reinterpret_cast<uint8_t*>(cot) + pad16((size_t)Nd * Cs * 2);
  float* et = reinterpret_cast<float*>(
      cot + pad16((size_t)Nd * Cs * 2) + pad16((size_t)Nd * Cs));
  int* nn = reinterpret_cast<int*>(et + pad4((size_t)E * ET));
  int* sp = nn + pad4(E);
  int* se = sp + pad4((size_t)rows + 1);

  // 1. stage, in two groups of copies: what dh needs (the slab of g in
  // 16-byte pieces, the argmax in 8, etype and the tables), then the slab
  // of h, which only d_etype reads and which arrives while dh runs; etype
  // (and mean's g / K) rounded in place once the first group is in
  const size_t g0 = (size_t)b * Nd * C + c0;
  for (int q = tid; q < Nd * cv; q += nt) {
    const int d = by_cv(q);
    const int c = (q - d * cv) * VEC;
    cp_async(gs + (size_t)d * Cs + c, g + g0 + (size_t)d * C + c, 16);
    if (AGG == AGG_MAX)
      cp_async(as + (size_t)d * Cs + c, argmax + g0 + (size_t)d * C + c, 8);
  }
  const float* eb = etype + (size_t)b * E * T;
  if (T % 4 == 0 && (reinterpret_cast<uintptr_t>(eb) & 15) == 0) {
    for (int q = tid; q < E * runs; q += nt) {
      const int e = by_runs(q);  // T / 4 == runs
      cp_async(et + (size_t)e * ET + 4 * (q - e * runs), eb + 4 * (size_t)q,
               16);
    }
  } else {
    for (int q = tid; q < E * T; q += nt) {
      const int e = by_t(q);
      cp_async(et + (size_t)e * ET + (q - e * T), eb + q, 4);
    }
  }
  for (int q = tid; q < E; q += nt) cp_async(nn + q, nn_idx + q, 4);
  for (int q = tid; q <= rows; q += nt) cp_async(sp + q, src_ptr + q, 4);
  for (int q = tid; q < 2 * E; q += nt) cp_async(se + q, src_edge + q, 4);
  cp_async_commit();
  const bf16* hb = h + (size_t)b * rows * T * C + c0;
  for (int q = tid; q < (N + nd) * T * cv; q += nt) {
    const int o = by_cv(q);  // o = slot T + t
    const int c = (q - o * cv) * VEC;
    const int slot = by_t(o);
    const int t = o - slot * T;
    const int r = slot < N ? 2 * slot + 1 : 2 * (d0 + slot - N);
    cp_async(hs + (size_t)slot * RS + t * Cs + c,
             hb + ((size_t)r * T + t) * C + c, 16);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int q = tid; q < E * T; q += nt) {
    const int e = by_t(q);
    float* w = et + (size_t)e * ET + (q - e * T);
    *w = rnd<bf16>(*w);
  }
  if (AGG == AGG_MEAN) {  // g / K in bf16, as staged_dm rounds it
    const float inv_k = 1.f / (float)K;
    for (int q = tid; q < Nd * Cs; q += nt)
      gs[q] = from_f32<bf16>(to_f32(gs[q]) * inv_k);
  }
  __syncthreads();

  // 2. dh: the rows 2 d and 2 d + 1 of the tile's d, items (side, d, run,
  // vector), vector fastest: the self rows first, so that a warp's items
  // take one path
  bf16* dhb = dh + (size_t)b * rows * T * C + c0;
  const FastDiv by_nd(nd);
  for (int q = tid; q < 2 * nd * runs * cv; q += nt) {
    const int o = by_cv(q);  // o = (side nd + dl) runs + run
    const int c = (q - o * cv) * VEC;
    const int sd = by_runs(o);
    const int t0 = (o - sd * runs) * 4;
    const int side = by_nd(sd);
    const int r = 2 * (d0 + sd - side * nd) + side;
    float acc[4][VEC];
    if (AGG == AGG_MAX && (r & 1) == 0) {
      // the self row: one product per (t, c), added to +0
      const int d = r >> 1;
      const uint4 gw = *reinterpret_cast<const uint4*>(gs + (size_t)d * Cs + c);
      const uint2 a = *reinterpret_cast<const uint2*>(as + (size_t)d * Cs + c);
      const unsigned gq[4] = {gw.x, gw.y, gw.z, gw.w};
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int k = ((i < 4 ? a.x : a.y) >> (8 * (i & 3))) & 0xff;
        const bool in = k < K;  // a slot past K: every term is zero
        const float gi = i & 1 ? unpack2(gq[i >> 1]).y : unpack2(gq[i >> 1]).x;
        float w[4];
        Vec<4>::lds(et + (size_t)(d * K + (in ? k : 0)) * ET + t0, w);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u][i] = in ? 0.f + rnd<bf16>(__fmul_rn(gi, w[u])) : 0.f;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[u][i] = 0.f;
      // the in-edges two at a time, both edges' loads first; the second
      // of an odd count adds nothing (n = 0)
      const int p1 = sp[r + 1];
      for (int p = sp[r]; p < p1; p += 2) {
        uint4 v[2];
        float w[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = se[min(p + x, p1 - 1)];
          const int d = by_k(e);
          v[x] = ext_dm<AGG>(gs, as, d, e - d * K, Cs, c);
          Vec<4>::lds(et + (size_t)e * ET + t0, w[x]);
        }
        const int n = min(2, p1 - p);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (x == n) break;
          const unsigned vq[4] = {v[x].x, v[x].y, v[x].z, v[x].w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 m = mul_rnd2(pair(vq[j]), w[x][u]);
              acc[u][2 * j] = acc[u][2 * j] + m.x;
              acc[u][2 * j + 1] = acc[u][2 * j + 1] + m.y;
            }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (t0 + u < T)
        Vec<VEC>::store(dhb + ((size_t)r * T + t0 + u) * C + c, acc[u]);
  }

  cp_async_wait<0>();
  __syncthreads();

  // 3. d_etype: items (run, d, vector), vector fastest, so that a
  // wavefront's self rows are consecutive d; the cv items of a (run, d) lie
  // in one warp and add their sums in a fixed butterfly
  float* dst = S > 1 ? part + (size_t)bs * E * T : d_etype + (size_t)b * E * T;
  const int items = nd * runs * cv;
  const int steps = (items + nt - 1) / nt;  // the same in every warp
  for (int it = 0; it < steps; ++it) {
    const int qq = it * nt + tid;
    const bool live = qq < items;  // whole groups of cv: items % cv == 0
    const int q = live ? qq : 0;
    const int o = by_cv(q);  // o = run nd + dl
    const int c = (q - o * cv) * VEC;
    const int run = by_nd(o);
    const int t0 = run * 4;
    const int d = d0 + (o - run * nd);
    float sv[4][VEC];  // the self row 2 d
#pragma unroll
    for (int u = 0; u < 4; ++u)
      Vec<VEC>::lds(hs + (size_t)(N + d - d0) * RS + min(t0 + u, T - 1) * Cs +
                        c,
                    sv[u]);
    const size_t gd = (size_t)d * Cs + c;
    const uint4 gw = *reinterpret_cast<const uint4*>(gs + gd);
    const uint2 a = AGG == AGG_MAX ? *reinterpret_cast<const uint2*>(as + gd)
                                   : make_uint2(0, 0);
    for (int k = 0; k < K; ++k) {
      const int e = d * K + k;
      const uint4 v = ext_mask<AGG>(gw, a, k);
      const unsigned vq[4] = {v.x, v.y, v.z, v.w};
      float x[VEC];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack2(vq[j]);
        x[2 * j] = f.x;
        x[2 * j + 1] = f.y;
      }
      const bf16* hn = hs + (size_t)nn[e] * RS + c;
      float sum[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float y[VEC];
        Vec<VEC>::lds(hn + min(t0 + u, T - 1) * Cs, y);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 pr =
              rnd2(__fmul_rn(x[2 * j], sv[u][2 * j] + y[2 * j]),
                   __fmul_rn(x[2 * j + 1], sv[u][2 * j + 1] + y[2 * j + 1]));
          acc = acc + pr.x;
          acc = acc + pr.y;
        }
        sum[u] = acc;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        for (int off = cv / 2; off > 0; off /= 2)
          sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], off);
      if (live && c == 0)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t0 + u < T) dst[(size_t)e * T + t0 + u] = sum[u];
    }
  }
}

// d_etype[b] = sum over the S slabs of part[b, s], in slab order: one
// thread per output.
__global__ void sum_slabs(const float* __restrict__ part,
                          float* __restrict__ d_etype, long long n, int S,
                          int ET) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long b = i / ET;
  const float* p = part + b * S * ET + (i - b * ET);
  float v = p[0];
  for (int s = 1; s < S; ++s) v += p[(size_t)s * ET];
  d_etype[i] = v;
}

// Shared memory of one block of ext_bwd_kernel, in bytes: staged_bytes'
// layout (bf16, max, sum or mean) with the slab of h cut to the N
// neighbour rows and the tile's td self rows.
inline size_t ext_bytes(int N, int td, int K, int T, int cs) {
  const size_t E = (size_t)N * K;
  return pad16((size_t)(N + td) * row_stride(T, cs, 2) * 2) +
         pad16((size_t)N * cs * 2) + pad16((size_t)N * cs) +
         4 * (pad4(E * et_stride(T, false)) + pad4(E) +
              pad4((size_t)2 * N + 1) + pad4(2 * E));
}

// sum_slabs after a launch with S > 1 slabs a sample
int add_slabs(cudaStream_t st, const float* part, float* d_etype, int B,
              int Nd, int K, int T, int S) {
  const long long n = (long long)B * Nd * K * T;
  sum_slabs<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      part, d_etype, n, S, Nd * K * T);
  return (int)cudaGetLastError();
}

template <int AGG>
int launch_ext(cudaStream_t st, const bf16* g, const uint8_t* argmax,
               const bf16* h, const int32_t* nn_idx, const int32_t* src_ptr,
               const int32_t* src_edge, const float* etype, bf16* dh,
               float* d_etype, float* part, int B, int N, int K, int T, int C,
               int cs, int tiles, size_t smem) {
  auto kernel = ext_bwd_kernel<AGG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int S = C / cs;
  kernel<<<(unsigned)((long long)B * S * tiles), EXT_THREADS, smem, st>>>(
      g, argmax, h, nn_idx, src_ptr, src_edge, etype, dh, d_etype, part, N,
      K, T, C, cs, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  return add_slabs(st, part, d_etype, B, N, K, T, S);
}

template <int AGG, int VEC, bool EXT, class TH>
int launch_staged(cudaStream_t st, const TH* g, const uint8_t* argmax,
                  const TH* h, const int32_t* nn_idx,
                  const int32_t* src_ptr, const int32_t* src_edge,
                  const float* etype, const float* out, TH* dh,
                  float* d_etype, int B, int N, int Nd, int K, int T, int C,
                  float gamma, float* part, int cs, int packed, int tiles) {
  const int S = C / cs;
  // the packed products where there are pairs to multiply (the entry
  // refuses `packed` elsewhere)
  constexpr bool CAN_PACK =
      std::is_same<TH, bf16>::value && VEC == 4 && AGG != AGG_SOFTMAX;
  const size_t smem = staged_bytes((EXT ? 2 : 1) * N, Nd, K, T, cs,
                                   AGG == AGG_SOFTMAX, (int)sizeof(TH));
  auto kernel = packed ? staged_bwd_kernel<AGG, VEC, EXT, TH, CAN_PACK>
                       : staged_bwd_kernel<AGG, VEC, EXT, TH, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)B * S * tiles), STAGED_THREADS, smem, st>>>(
      g, argmax, h, nn_idx, src_ptr, src_edge, etype, out, dh, d_etype, part,
      N, Nd, K, T, C, cs, tiles, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  return add_slabs(st, part, d_etype, B, Nd, K, T, S);
}

// --------------------------------------------------------------------------
// the kept route: the first kernels of the port

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
int launch_kept(cudaStream_t s, const float* g, const uint8_t* argmax,
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

// --------------------------------------------------------------------------
// dispatch: the aggregator, the vector width and the mode are template
// arguments of each route's launcher

// the staged route in the mode of its pointers' type; the kept route, f32
struct Staged {
  template <int AGG, int VEC, bool EXT, typename... A>
  static int run(A... a) { return launch_staged<AGG, VEC, EXT>(a...); }
};
struct Kept {
  template <int AGG, int VEC, bool EXT, typename... A>
  static int run(A... a) { return launch_kept<AGG, VEC, EXT>(a...); }
};

template <class Route, int VEC, bool EXT, typename... A>
int dispatch(int aggregator, A... a) {
  switch (aggregator) {
    case AGG_MAX: return Route::template run<AGG_MAX, VEC, EXT>(a...);
    case AGG_SUM: return Route::template run<AGG_SUM, VEC, EXT>(a...);
    case AGG_MEAN: return Route::template run<AGG_MEAN, VEC, EXT>(a...);
    case AGG_SOFTMAX: return Route::template run<AGG_SOFTMAX, VEC, EXT>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Route, typename... A>
int by_mode(int vec4, int ext, int aggregator, A... a) {
  if (vec4)
    return ext ? dispatch<Route, 4, true>(aggregator, a...)
               : dispatch<Route, 4, false>(aggregator, a...);
  return ext ? dispatch<Route, 1, true>(aggregator, a...)
             : dispatch<Route, 1, false>(aggregator, a...);
}

// The arguments both routes refuse.
bool refused(const uint8_t* argmax, const float* out, int B, int N, int Nd,
             int K, int T, int C, int aggregator, int vec4, int ext) {
  return B <= 0 || N <= 0 || Nd <= 0 || K <= 0 || K > 255 || T <= 0 ||
         T > MAX_T || C <= 0 || (vec4 && C % 4 != 0) || (ext && Nd != N) ||
         (aggregator == AGG_MAX && argmax == nullptr) ||
         (aggregator == AGG_SOFTMAX && out == nullptr);
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per route.  Each launches
// on `stream` and returns the CUDA error of its launches, or
// cudaErrorInvalidValue for arguments it does not take.  `argmax` is
// needed for max and `out` for softmax; either may be null otherwise.
// `vec4` asks for the 16-byte path, which needs C % 4 == 0 (and, staged,
// cs % 4 == 0), 16-byte aligned g, h, out and dh and a 4-byte aligned
// argmax.  `ext` selects the DIFF/NEIGHBOR mode: h and dh have 2 N rows,
// Nd == N, and src_ptr/src_edge are the 2 N-row table.

// The staged route: `cs` channels per block, a divisor of C with
// C / cs <= 8 whose shared memory fits in a block.  With S = C / cs > 1,
// `part` is scratch for the S partial sums of d_etype, (B, S, Nd, K, T)
// f32.  `bf16` says g, h and dh are bf16 (the bf16 mode); `out` is the f32
// log-sum-exp in either mode.  `packed` picks the bf16 mode's products: 0
// scalar (the kept route), 1 packed bf16 pairs, which max, sum and mean take
// on the vector path (vec4) only.
extern "C" int typed_mp_bwd_staged(const void* g, const uint8_t* argmax,
                                   const void* h, const int32_t* nn_idx,
                                   const int32_t* src_ptr,
                                   const int32_t* src_edge,
                                   const float* etype, const float* out,
                                   void* dh, float* d_etype, int B, int N,
                                   int Nd, int K, int T, int C,
                                   int aggregator, float gamma, int vec4,
                                   int ext, int bf16_mode, int packed,
                                   float* part, int cs, int tiles,
                                   void* stream) {
  if (tiles > 1) tiles = (Nd + (Nd + tiles - 1) / tiles - 1) /
                         ((Nd + tiles - 1) / tiles);  // none empty
  if (refused(argmax, out, B, N, Nd, K, T, C, aggregator, vec4, ext) ||
      cs <= 0 || C % cs != 0 || C / cs > MAX_SLABS || (vec4 && cs % 4 != 0) ||
      tiles < 1 || (tiles > 1 && !ext) ||
      (C / cs > 1 && part == nullptr) ||
      (long long)B * (C / cs) * tiles > INT_MAX ||
      packed < 0 || packed > 1 ||
      (packed && (!bf16_mode || !vec4 || aggregator == AGG_SOFTMAX)) ||
      (long long)B * Nd * K * T / THREADS >= INT_MAX ||
      staged_bytes((ext ? 2 : 1) * N, Nd, K, T, cs,
                   aggregator == AGG_SOFTMAX, bf16_mode ? 2 : 4) >
          SMEM_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (bf16_mode)
    return by_mode<Staged>(vec4, ext, aggregator, (cudaStream_t)stream,
                           static_cast<const bf16*>(g), argmax,
                           static_cast<const bf16*>(h), nn_idx, src_ptr,
                           src_edge, etype, out, static_cast<bf16*>(dh),
                           d_etype, B, N, Nd, K, T, C, gamma, part, cs,
                           packed, tiles);
  return by_mode<Staged>(vec4, ext, aggregator, (cudaStream_t)stream,
                         static_cast<const float*>(g), argmax,
                         static_cast<const float*>(h), nn_idx, src_ptr,
                         src_edge, etype, out, static_cast<float*>(dh),
                         d_etype, B, N, Nd, K, T, C, gamma, part, cs, 0,
                         tiles);
}

// The bf16 DIFF/NEIGHBOR design (ext_bwd_kernel): bf16 g, h and dh (B,
// 2 N, T, C), Nd == N, the 2 N-row transposed table; max, sum or mean
// (`argmax` needed for max).  `cs` channels per block, cs % 8 == 0 and
// C / cs <= 8, in `tiles` tiles of destination rows; with S = C / cs > 1,
// `part` is scratch for the slabs' partial sums of d_etype, as for
// typed_mp_bwd_staged.  g, h and dh 16-byte aligned, argmax 8-byte.
extern "C" int typed_mp_bwd_ext(const void* g, const uint8_t* argmax,
                                const void* h, const int32_t* nn_idx,
                                const int32_t* src_ptr,
                                const int32_t* src_edge, const float* etype,
                                void* dh, float* d_etype, int B, int N, int K,
                                int T, int C, int aggregator, float* part,
                                int cs, int tiles, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(h) |
        reinterpret_cast<uintptr_t>(dh)) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(argmax) & 7) == 0;
  if (tiles > 1) tiles = (N + (N + tiles - 1) / tiles - 1) /
                         ((N + tiles - 1) / tiles);  // none empty
  const size_t smem =
      cs > 0 && tiles > 0 ? ext_bytes(N, (N + tiles - 1) / tiles, K, T, cs)
                          : 0;
  if (refused(argmax, nullptr, B, N, N, K, T, C, aggregator, 1, 1) ||
      aggregator < AGG_MAX || aggregator > AGG_MEAN || !aligned || cs <= 0 ||
      cs % 8 != 0 || ((cs / 8) & (cs / 8 - 1)) != 0 || C % cs != 0 ||
      C / cs > MAX_SLABS || (C / cs > 1 && part == nullptr) ||
      tiles < 1 || tiles > N || (long long)B * (C / cs) * tiles > INT_MAX ||
      (long long)B * N * K * T / THREADS >= INT_MAX || smem > SMEM_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* gp = static_cast<const bf16*>(g);
  const bf16* hp = static_cast<const bf16*>(h);
  bf16* dp = static_cast<bf16*>(dh);
  switch (aggregator) {
    case AGG_MAX:
      return launch_ext<AGG_MAX>(st, gp, argmax, hp, nn_idx, src_ptr,
                                 src_edge, etype, dp, d_etype, part, B, N, K,
                                 T, C, cs, tiles, smem);
    case AGG_SUM:
      return launch_ext<AGG_SUM>(st, gp, argmax, hp, nn_idx, src_ptr,
                                 src_edge, etype, dp, d_etype, part, B, N, K,
                                 T, C, cs, tiles, smem);
    default:
      return launch_ext<AGG_MEAN>(st, gp, argmax, hp, nn_idx, src_ptr,
                                  src_edge, etype, dp, d_etype, part, B, N,
                                  K, T, C, cs, tiles, smem);
  }
}

// The kept route: the first kernels of the port, for any size.
extern "C" int typed_mp_bwd(const float* g, const uint8_t* argmax,
                            const float* h, const int32_t* nn_idx,
                            const int32_t* src_ptr, const int32_t* src_edge,
                            const float* etype, const float* out, float* dh,
                            float* d_etype, int B, int N, int Nd, int K, int T,
                            int C, int aggregator, float gamma, int vec4,
                            int ext, void* stream) {
  if (refused(argmax, out, B, N, Nd, K, T, C, aggregator, vec4, ext))
    return (int)cudaErrorInvalidValue;
  return by_mode<Kept>(vec4, ext, aggregator, (cudaStream_t)stream, g, argmax,
                       h, nn_idx, src_ptr, src_edge, etype, out, dh, d_etype,
                       B, N, Nd, K, T, C, gamma);
}
