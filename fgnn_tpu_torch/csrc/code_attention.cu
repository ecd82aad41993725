// Code-aware masked attention of the Error Correction Code Transformer
// (fgnn_tpu_torch/models/ecct.py), forward and backward, over the pairs the
// code's mask allows and no others (Hopper, sm_90a).  f32 or bf16 storage,
// f32 arithmetic.
//
// Replaces no TPU kernel: the JAX package has no ECCT.  It replaces the
// port's call of torch's scaled_dot_product_attention, whose f32 route (the
// memory-efficient back end) runs SIMT 64 x 64 tiles over all L^2 query-key
// pairs with the mask added as a bias.  The code's mask (Algorithm 1 of
// arXiv:2203.14966, data/ldpc_graph.py) allows 2198 of the 144^2 = 20736
// pairs of MacKay's (96,48) code: a bit token attends to 19-27 tokens, a
// check token to 7-8.
//
// What bounds it on the H100: bytes.  At d = 16 a pair costs 2 d
// multiply-adds and one exponential, about 10 pairs per query, so the forward
// does some 80 operations per 64 bytes of q it reads, far below the ridge.
// The forward has to read q, k and v once and write out (and the log-sum-exp)
// once; the backward reads q, k, v, o, dO and the log-sum-exp and writes dq,
// dk and dv.  The design touches device memory once for each of them:
//
// * one block per (word, group of HG heads).  The block stages the group's
//   rows of its word in shared memory as f32 (f32 by asynchronous copies
//   that fly while the first q rows are read, bf16 widened as it is read):
//   K and V for the forward; Q (times the scale), K, V and dO, the
//   log-sum-exp and D = rowsum(dO * O) for the backward.  A staged row of a
//   token holds its HG heads of DH values; HG = 32 / DH makes it 128 bytes,
//   so that every row starts on bank 0.
// * a thread owns a (query, head) row (one a thread, up to FWD_THREADS or
//   BWD_THREADS; the tables list the queries longest first, so the lanes of
//   a warp walk rows of about the same length).  It keeps q in registers and
//   walks the query's allowed keys from a table built once per mask on the
//   host (the rows in order, their lengths, and the keys as a (length, L)
//   array, so that the lanes of a warp read one line of it at each step):
//   per key a dot product from shared memory, an online softmax with one
//   expf, and the weighted sum of v; two keys in flight (unroll 2).
// * the 8 lanes that share a shared-memory wavefront of a 16-byte load read
//   the 16-byte chunks of their rows in an order rotated by the lane: lane
//   l reads chunk (c + rot) mod DH/4 at step c, rot = (l mod 8) DH/4 / 8.
//   With HG = 32 / DH the 8 lanes then hit 8 different bank groups whatever
//   rows they read, so the key gathers are free of bank conflicts.  q, the
//   sums and the outputs are kept in registers in that same rotated order.
// * the backward uses FlashAttention's recurrences restricted to the
//   tables: p_ij = exp(s_ij - lse_i) and ds_ij = p_ij (dO_i . v_j - D_i)
//   recomputed from shared memory, dq_i = scale sum_j ds_ij k_j over the
//   query's row table, then dk_j = scale sum_i ds_ij q_i and dv_j =
//   sum_i p_ij dO_i over the key's column table (the queries that may attend
//   to it).  Each gradient row is written by the one thread that sums it: no
//   atomics and no scratch beyond the log-sum-exp, and two launches give the
//   same bits.  The mask need not be symmetric.
//
// Tried on the H100 at the ECCT cell's shape and slower: a persistent
// forward with two K/V buffers, outputs staged in shared memory for whole-
// line stores, and a backward that keeps each pair's p and ds in shared
// memory for the key pass (fewer operations, but the memory it takes costs
// more than they save).
//
// q, k, v, out, o, dO, dq, dk and dv share one layout (B, H, L, DH) given by
// the strides (sb, sh, sl) in elements, the last stride 1: the model passes
// views of its (B, L, H DH) maps, read in place.  The log-sum-exp is (B, H,
// L) f32.  Each entry point launches on the caller's stream, allocates
// nothing and never synchronises; it returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.  The
// wrapper (fgnn_tpu_torch/ops/code_attention.py) builds the tables, checks
// the shapes and allocates the outputs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_PER_BLOCK = 232448;
// threads a block: one (query, head) row each, in whole warps, at most
// these (a thread takes the rows beyond them too); two backward
// blocks an SM at head widths up to 16 (at most 128 registers a thread)
constexpr int FWD_THREADS = 512;
constexpr int BWD_THREADS = 256;
constexpr int STATIC_SMEM = 48 * 1024;

// four consecutive elements of global memory, as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 scaled(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// a + s * b
__device__ __forceinline__ float4 axpy(float4 a, float s, float4 b) {
  return make_float4(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y), fmaf(s, b.z, a.z),
                     fmaf(s, b.w, a.w));
}

// a * c + s * b
__device__ __forceinline__ float4 rescale_axpy(float4 a, float c, float s,
                                               float4 b) {
  return make_float4(fmaf(s, b.x, a.x * c), fmaf(s, b.y, a.y * c),
                     fmaf(s, b.z, a.z * c), fmaf(s, b.w, a.w * c));
}

// the dot product of a rotated register row with a shared row: four
// partial sums, one per lane of the float4, added at the end
template <int NC>
__device__ __forceinline__ float dot(const float4 (&a)[NC],
                                     const float4* __restrict__ row,
                                     int rot) {
  float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 b = row[(c + rot) & (NC - 1)];
    sx = fmaf(a[c].x, b.x, sx);
    sy = fmaf(a[c].y, b.y, sy);
    sz = fmaf(a[c].z, b.z, sz);
    sw = fmaf(a[c].w, b.w, sw);
  }
  return (sx + sy) + (sz + sw);
}

// a row of DH values at p (global), into registers in the rotated order
template <int NC, typename T>
__device__ __forceinline__ void load_row(float4 (&r)[NC], const T* p,
                                         int rot, float mul) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    r[c] = scaled(load4(p + 4 * ((c + rot) & (NC - 1))), mul);
}

// the same from a shared row
template <int NC>
__device__ __forceinline__ void load_row(float4 (&r)[NC],
                                         const float4* __restrict__ row,
                                         int rot) {
#pragma unroll
  for (int c = 0; c < NC; ++c) r[c] = row[(c + rot) & (NC - 1)];
}

// a rotated register row, times mul, into a row of DH values at p (global)
template <int NC, typename T>
__device__ __forceinline__ void store_row(T* p, const float4 (&r)[NC],
                                          int rot, float mul) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    store4(p + 4 * ((c + rot) & (NC - 1)), scaled(r[c], mul));
}

// tokens [0, L) of the HG heads at src (global, element offsets i sl + hh sh
// + c) into dst (shared, (L, HG * DH) f32): f32 by asynchronous 16-byte
// copies (cp.async; complete after stage_wait), bf16 widened through
// registers
template <int DH>
__device__ __forceinline__ void stage(float4* __restrict__ dst,
                                      const float* __restrict__ src, int L,
                                      int HG, long long sh, long long sl) {
  constexpr int NC = DH / 4;
  const int per_token = HG * NC;
  const int total = L * per_token;
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    const int i = u / per_token, rem = u - i * per_token;
    const int hh = rem / NC, c = rem - hh * NC;
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + u));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + i * sl + hh * sh + 4 * c));
  }
}
template <int DH>
__device__ __forceinline__ void stage(float4* __restrict__ dst,
                                      const __nv_bfloat16* __restrict__ src,
                                      int L, int HG, long long sh,
                                      long long sl) {
  constexpr int NC = DH / 4;
  const int per_token = HG * NC;
  const int total = L * per_token;
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    const int i = u / per_token, rem = u - i * per_token;
    const int hh = rem / NC, c = rem - hh * NC;
    dst[u] = load4(src + i * sl + hh * sh + 4 * c);
  }
}

// this thread's asynchronous copies done (a __syncthreads must follow before
// other threads read them)
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the values this thread staged into dst, times mul (after stage_wait)
template <int DH>
__device__ __forceinline__ void scale_staged(float4* __restrict__ dst, int L,
                                             int HG, float mul) {
  const int total = L * HG * (DH / 4);
  for (int u = threadIdx.x; u < total; u += blockDim.x)
    dst[u] = scaled(dst[u], mul);
}

// The table of one direction, by slot s (the rows longest first): the row
// order[s], its length count[s] and its n-th column key[n L + s], ascending
// in n.  The lanes of a warp hold consecutive slots, so each step of their
// walks reads consecutive words.
struct Table {
  const int* order;
  const int* count;
  const int* key;
  int L;
  __device__ __forceinline__ Table(const int* t, int L_)
      : order(t), count(t + L_), key(t + 2 * L_), L(L_) {}
  __device__ __forceinline__ int at(int n, int s) const {
    return key[n * L + s];
  }
};

// The forward: out = softmax over the allowed keys of (q k / sqrt(DH)) times
// v, and lse = the log of the softmax's sum plus its max, per (b, h, i).
template <typename T, int DH>
__global__ void __launch_bounds__(FWD_THREADS)
code_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ rows,
                     int H, int L, int HG, long long sb, long long sh,
                     long long sl, float scale) {
  constexpr int NC = DH / 4;
  extern __shared__ float4 smem[];
  const int rw = HG * NC;  // float4s of a staged token
  float4* ks = smem;
  float4* vs = ks + L * rw;
  const int groups = H / HG;
  const long long b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * HG;
  const long long base = b * sb + h0 * sh;
  stage<DH>(ks, k + base, L, HG, sh, sl);
  stage<DH>(vs, v + base, L, HG, sh, sl);

  const Table tab(rows, L);
  const int rot = ((threadIdx.x & 7) * NC) >> 3;
  const int R = L * HG;
  float4 qr[NC];
  // the first row's q is read while the copies are in flight
  if (threadIdx.x < R)
    load_row<NC>(qr, q + base + (threadIdx.x % HG) * sh +
                         tab.order[threadIdx.x / HG] * sl,
                 rot, scale);
  stage_wait();
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int s = r / HG, hh = r % HG;
    const int i = tab.order[s], cnt = tab.count[s];
    const long long off = base + hh * sh + i * sl;
    if (r != threadIdx.x) load_row<NC>(qr, q + off, rot, scale);
    const float4* kh = ks + hh * NC;
    const float4* vh = vs + hh * NC;
    float4 acc[NC];
    int j = tab.at(0, s);
    float m = dot<NC>(qr, kh + j * rw, rot), l = 1.f;
    load_row<NC>(acc, vh + j * rw, rot);
#pragma unroll 2
    for (int n = 1; n < cnt; ++n) {
      j = tab.at(n, s);
      const float sc = dot<NC>(qr, kh + j * rw, rot);
      // max(m, sc) and both exponentials of the online softmax from one expf
      const float e = expf(-fabsf(sc - m));
      const bool up = sc > m;
      const float corr = up ? e : 1.f, p = up ? 1.f : e;
      m = up ? sc : m;
      l = fmaf(l, corr, p);
      const float4* vj = vh + j * rw;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[c] = rescale_axpy(acc[c], corr, p, vj[(c + rot) & (NC - 1)]);
    }
    store_row<NC>(out + off, acc, rot, 1.f / l);
    lse[(b * H + h0 + hh) * L + i] = m + logf(l);
  }
}

// The backward: dq, dk and dv of the forward's out against dout, from the
// forward's lse.  The query pass walks the row table, the key pass the
// column table; both recompute p and ds from shared memory.
template <typename T, int DH>
__global__ void __launch_bounds__(BWD_THREADS, DH <= 16 ? 2 : 1)
code_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols, int H, int L, int HG,
                     long long sb, long long sh, long long sl, float scale) {
  constexpr int NC = DH / 4;
  extern __shared__ float4 smem[];
  const int rw = HG * NC;
  float4* qs = smem;  // q times the scale
  float4* ks = qs + L * rw;
  float4* vs = ks + L * rw;
  float4* ds = vs + L * rw;   // dout
  float* ls = reinterpret_cast<float*>(ds + L * rw);  // (L, HG) lse
  float* Ds = ls + L * HG;                             // (L, HG) D
  const int groups = H / HG;
  const long long b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * HG;
  const long long base = b * sb + h0 * sh;
  stage<DH>(qs, q + base, L, HG, sh, sl);
  stage<DH>(ks, k + base, L, HG, sh, sl);
  stage<DH>(vs, v + base, L, HG, sh, sl);
  stage<DH>(ds, dout + base, L, HG, sh, sl);
  for (int u = threadIdx.x; u < L * HG; u += blockDim.x)
    ls[(u % L) * HG + u / L] = lse[(b * H + h0) * L + u];
  stage_wait();
  scale_staged<DH>(qs, L, HG, scale);
  __syncthreads();
  // D_i = dO_i . O_i
  for (int u = threadIdx.x; u < L * HG; u += blockDim.x) {
    const int i = u / HG, hh = u % HG;
    const T* orow = o + base + hh * sh + i * sl;
    const float4* drow = ds + i * rw + hh * NC;
    float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 a = load4(orow + 4 * c), g = drow[c];
      sx = fmaf(a.x, g.x, sx);
      sy = fmaf(a.y, g.y, sy);
      sz = fmaf(a.z, g.z, sz);
      sw = fmaf(a.w, g.w, sw);
    }
    Ds[u] = (sx + sy) + (sz + sw);
  }
  __syncthreads();

  const int rot = ((threadIdx.x & 7) * NC) >> 3;
  // the query pass: dq_i = scale sum_j ds_ij k_j
  const Table rt(rows, L);
  for (int r = threadIdx.x; r < L * HG; r += blockDim.x) {
    const int s = r / HG, hh = r % HG;
    const int i = rt.order[s], cnt = rt.count[s];
    float4 qr[NC], gr[NC], acc[NC];
    load_row<NC>(qr, qs + i * rw + hh * NC, rot);
    load_row<NC>(gr, ds + i * rw + hh * NC, rot);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float li = ls[i * HG + hh], Di = Ds[i * HG + hh];
    const float4* kh = ks + hh * NC;
    const float4* vh = vs + hh * NC;
#pragma unroll 2
    for (int n = 0; n < cnt; ++n) {
      const int j = rt.at(n, s);
      float4 kr[NC];
      load_row<NC>(kr, kh + j * rw, rot);
      float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        sx = fmaf(qr[c].x, kr[c].x, sx);
        sy = fmaf(qr[c].y, kr[c].y, sy);
        sz = fmaf(qr[c].z, kr[c].z, sz);
        sw = fmaf(qr[c].w, kr[c].w, sw);
      }
      const float p = expf(((sx + sy) + (sz + sw)) - li);
      const float dsij = p * (dot<NC>(gr, vh + j * rw, rot) - Di);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = axpy(acc[c], dsij, kr[c]);
    }
    store_row<NC>(dq + base + hh * sh + i * sl, acc, rot, scale);
  }
  // the key pass: dk_j = scale sum_i ds_ij q_i (q staged times the scale),
  // dv_j = sum_i p_ij dO_i
  const Table ct(cols, L);
  for (int r = threadIdx.x; r < L * HG; r += blockDim.x) {
    const int s = r / HG, hh = r % HG;
    const int j = ct.order[s], cnt = ct.count[s];
    float4 kr[NC], vr[NC], gk[NC], gv[NC];
    load_row<NC>(kr, ks + j * rw + hh * NC, rot);
    load_row<NC>(vr, vs + j * rw + hh * NC, rot);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      gk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      gv[c] = gk[c];
    }
    const float4* qh = qs + hh * NC;
    const float4* dh = ds + hh * NC;
#pragma unroll 2
    for (int n = 0; n < cnt; ++n) {
      const int i = ct.at(n, s);
      float4 qr[NC], gr[NC];
      load_row<NC>(qr, qh + i * rw, rot);
      load_row<NC>(gr, dh + i * rw, rot);
      float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
      float tx = 0.f, ty = 0.f, tz = 0.f, tw = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        sx = fmaf(qr[c].x, kr[c].x, sx);
        sy = fmaf(qr[c].y, kr[c].y, sy);
        sz = fmaf(qr[c].z, kr[c].z, sz);
        sw = fmaf(qr[c].w, kr[c].w, sw);
        tx = fmaf(gr[c].x, vr[c].x, tx);
        ty = fmaf(gr[c].y, vr[c].y, ty);
        tz = fmaf(gr[c].z, vr[c].z, tz);
        tw = fmaf(gr[c].w, vr[c].w, tw);
      }
      const float p = expf(((sx + sy) + (sz + sw)) - ls[i * HG + hh]);
      const float dsij = p * (((tx + ty) + (tz + tw)) - Ds[i * HG + hh]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        gk[c] = axpy(gk[c], dsij, qr[c]);
        gv[c] = axpy(gv[c], p, gr[c]);
      }
    }
    const long long off = base + hh * sh + j * sl;
    store_row<NC>(dk + off, gk, rot, 1.f);
    store_row<NC>(dv + off, gv, rot, 1.f);
  }
}

// Shared bytes of a block: K and V (forward); Q, K, V, dO, lse and D
// (backward).
long long fwd_smem(int L, int HG, int dh) { return 2LL * L * HG * dh * 4; }
long long bwd_smem(int L, int HG, int dh) {
  return 4LL * L * HG * dh * 4 + 2LL * L * HG * 4;
}

// a thread a row, whole warps, at most cap
int threads_for(int L, int HG, int cap) {
  const int t = (L * HG + 31) / 32 * 32;
  return t < cap ? t : cap;
}

bool takes(const void* const* ptrs, int n, int B, int H, int L, int dh,
           int HG, long long sb, long long sh, long long sl, int esz,
           long long smem) {
  if (B < 0 || H <= 0 || L <= 0 || HG <= 0 || H % HG != 0 ||
      (dh != 4 && dh != 8 && dh != 16 && dh != 32) || smem > SMEM_PER_BLOCK)
    return false;
  if ((long long)B * (H / HG) > 0x7fffffffLL) return false;
  // four elements at a time: the strides and the pointers in whole chunks
  if (sb % 4 || sh % 4 || sl % 4) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % (4 * esz)) return false;
  return true;
}

template <typename Kernel>
int launch_config(Kernel* kernel, long long smem) {
  if (smem > STATIC_SMEM)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <typename T, int DH>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const int* rows, int B, int H, int L, int HG,
               long long sb, long long sh, long long sl, float scale,
               cudaStream_t s) {
  const long long smem = fwd_smem(L, HG, DH);
  const int err = launch_config(code_attn_fwd_kernel<T, DH>, smem);
  if (err) return err;
  const unsigned blocks = (unsigned)(B * (H / HG));
  code_attn_fwd_kernel<T, DH>
      <<<blocks, threads_for(L, HG, FWD_THREADS), (size_t)smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, rows, H, L, HG,
      sb, sh, sl, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, const int* rows, const int* cols, int B, int H,
               int L, int HG, long long sb, long long sh, long long sl,
               float scale, cudaStream_t s) {
  const long long smem = bwd_smem(L, HG, DH);
  const int err = launch_config(code_attn_bwd_kernel<T, DH>, smem);
  if (err) return err;
  const unsigned blocks = (unsigned)(B * (H / HG));
  code_attn_bwd_kernel<T, DH>
      <<<blocks, threads_for(L, HG, BWD_THREADS), (size_t)smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), rows, cols, H, L, HG, sb, sh,
      sl, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward.  q, k, v and out (B, H, L, dh) at strides (sb, sh, sl, 1),
// f32 or (bf16 != 0) bf16; lse (B, H, L) f32; rows the row table of the
// mask (int32: the rows in order, their lengths, the keys by step).  HG
// heads a block, H % HG == 0; dh 4, 8, 16 or 32.
extern "C" int code_attn_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, const int* rows, int B,
                             int H, int L, int dh, int HG, long long sb,
                             long long sh, long long sl, float scale,
                             int bf16, void* stream) {
  const void* ptrs[] = {q, k, v, out};
  if (!takes(ptrs, 4, B, H, L, dh, HG, sb, sh, sl, bf16 ? 2 : 4,
             fwd_smem(L, HG, dh)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FWD(T, D)                                                          \
  return launch_fwd<T, D>(q, k, v, out, lse, rows, B, H, L, HG, sb, sh, sl, \
                          scale, s)
  if (bf16) {
    switch (dh) {
      case 4: FWD(__nv_bfloat16, 4);
      case 8: FWD(__nv_bfloat16, 8);
      case 16: FWD(__nv_bfloat16, 16);
      default: FWD(__nv_bfloat16, 32);
    }
  }
  switch (dh) {
    case 4: FWD(float, 4);
    case 8: FWD(float, 8);
    case 16: FWD(float, 16);
    default: FWD(float, 32);
  }
#undef FWD
}

// The backward.  q, k, v, o (the forward's out), dout, dq, dk and dv in the
// forward's layout and dtype; lse the forward's; rows and cols the row and
// column tables of the mask.
extern "C" int code_attn_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, void* dq, void* dk, void* dv,
                             const int* rows, const int* cols, int B, int H,
                             int L, int dh, int HG, long long sb,
                             long long sh, long long sl, float scale,
                             int bf16, void* stream) {
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  if (!takes(ptrs, 8, B, H, L, dh, HG, sb, sh, sl, bf16 ? 2 : 4,
             bwd_smem(L, HG, dh)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define BWD(T, D)                                                           \
  return launch_bwd<T, D>(q, k, v, o, dout, lse, dq, dk, dv, rows, cols, B, \
                          H, L, HG, sb, sh, sl, scale, s)
  if (bf16) {
    switch (dh) {
      case 4: BWD(__nv_bfloat16, 4);
      case 8: BWD(__nv_bfloat16, 8);
      case 16: BWD(__nv_bfloat16, 16);
      default: BWD(__nv_bfloat16, 32);
    }
  }
  switch (dh) {
    case 4: BWD(float, 4);
    case 8: BWD(float, 8);
    case 16: BWD(float, 16);
    default: BWD(float, 32);
  }
#undef BWD
}
