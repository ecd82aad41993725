// Helpers shared by typed_mp_fwd.cu and typed_mp_bwd.cu: the aggregator
// codes, loads and stores of 1 and 4 values of f32 or bf16 (converted to and
// from f32 in registers; 8 bf16 for the bf16-only routes), the packed bf16
// products (mul_rnd2) and pair rounding (rnd2), cp.async into shared memory
// (in groups, too), index division by one multiply, and the row stride of
// a staged slab of h.
// ops/fused_mp.py:build rebuilds a library when this header changes.
//
// The storage type TH of h (and of out, g and dh) is float or bf16: the
// kernels' f32 and bf16 modes.  Arithmetic is f32 in both; rnd<TH> rounds a
// value where the bf16 mode of the TPU kernel rounds it (to nearest even, as
// torch's .to(torch.bfloat16)), and is the identity for f32, so the f32
// instantiations compute what they computed before the bf16 mode existed.
// The bf16-only routes round through rnd<bf16>, mul_rnd2 and rnd2 alone (a
// store to bf16 rounds too: out, dh, and mean's g / K in the backward).

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Agg { AGG_MAX = 0, AGG_SUM = 1, AGG_MEAN = 2, AGG_SOFTMAX = 3 };

constexpr int SMEM_PER_BLOCK = 232448;  // shared memory an H100 block may use

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <class TH>
__device__ __forceinline__ TH from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to TH and back: bf16's round to nearest even, f32's identity
template <class TH>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<TH>(v));
}

// acc + a b, as the mode sums products: f32 fuses them (fmaf), bf16 rounds
// each product to bf16 first, as the TPU kernel rounds a matmul operand
template <class TH>
__device__ __forceinline__ float mac(float a, float b, float acc) {
  if constexpr (std::is_same<TH, float>::value)
    return fmaf(a, b, acc);
  else
    return acc + rnd<TH>(__fmul_rn(a, b));
}

// The bits of a bf16 pair, and the pair of f32 values a word of two bf16
// holds (the low half is the first element).
__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float2 unpack2(unsigned w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// The two products a.x b.x and a.y b.y of bf16 pairs, each rounded once to
// bf16, as f32: one packed mul.rn.bf16x2 where the scalar bf16 mode pays
// __fmul_rn, a round to bf16 and a widening per product.  The bits are
// those of rnd<bf16>(__fmul_rn(a, b)): the product of two bf16 values (8
// significant bits each) is exact in f32 wherever it lies in f32's normal
// range, and below it rounding the f32 product to bf16 still gives the
// rounding of the exact product (tests/test_torch_bf16_products.py).
__device__ __forceinline__ float2 mul_rnd2(__nv_bfloat162 a,
                                           __nv_bfloat162 b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(bits(a)), "r"(bits(b)));
  return unpack2(r);
}
// the same with b = (w, w): w rounded to bf16 first, as rnd<bf16>(w)
__device__ __forceinline__ float2 mul_rnd2(__nv_bfloat162 a, float w) {
  return mul_rnd2(a, __float2bfloat162_rn(w));
}

// a and b each rounded to bf16 and back, as rnd<bf16> rounds them, with one
// cvt.rn.bf16x2.f32 for the pair
__device__ __forceinline__ float2 rnd2(float a, float b) {
  return unpack2(bits(__floats2bfloat162_rn(a, b)));
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void load(const bf16* p, float* v) {
    v[0] = __bfloat162float(__ldg(p));
  }
  __device__ static void load_u8(const uint8_t* p, int* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { p[0] = v[0]; }
  __device__ static void store(bf16* p, const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
  __device__ static void store_u8(uint8_t* p, const int* v) { p[0] = (uint8_t)v[0]; }
  // shared memory
  __device__ static void lds(const float* p, float* v) { v[0] = p[0]; }
  __device__ static void lds(const bf16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
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
  __device__ static void store_u8(uint8_t* p, const int* v) {
    *reinterpret_cast<uchar4*>(p) =
        make_uchar4((uint8_t)v[0], (uint8_t)v[1], (uint8_t)v[2], (uint8_t)v[3]);
  }
  __device__ static void lds(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  // bf16: 8 bytes, two pairs
  __device__ static void unpack(uint2 q, float* v) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ static void load(const bf16* p, float* v) {
    unpack(__ldg(reinterpret_cast<const uint2*>(p)), v);
  }
  __device__ static void lds(const bf16* p, float* v) {
    unpack(*reinterpret_cast<const uint2*>(p), v);
  }
  __device__ static void store(bf16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&a);
    q.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

// 8 bf16 in 16 bytes (the bf16-only routes), with their argmax (8 bytes)
// and f32 log-sum-exp (32 bytes)
template <>
struct Vec<8> {
  __device__ static void lds(const bf16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(bf16* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void store(float* p, const float* v) {
    Vec<4>::store(p, v);
    Vec<4>::store(p + 4, v + 4);
  }
  __device__ static void store_u8(uint8_t* p, const int* v) {
    Vec<4>::store_u8(p, v);
    Vec<4>::store_u8(p + 4, v + 4);
  }
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

// Stage VEC values of type T into shared memory: cp.async for 4, 8 or 16
// bytes; a single bf16 (2 bytes, under cp.async's least copy) through a
// register.  Visible after cp_async_wait_all() and __syncthreads().
template <int VEC, class T>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  constexpr int bytes = VEC * (int)sizeof(T);
  if constexpr (bytes >= 4)
    cp_async(dst, src, bytes);
  else
    *dst = *src;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the group of the copies issued since the last one; then
// cp_async_wait<N>() waits until at most the N latest groups are pending.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q / d in one multiply, exact for q * d < 2^32 (every index here: shared
// memory bounds them to 2^16).
struct FastDiv {
  int d;
  unsigned m;
  __device__ explicit FastDiv(int d_)
      : d(d_), m(d_ > 1 ? 0xffffffffu / (unsigned)d_ + 1 : 0) {}
  __device__ int operator()(int q) const {
    return d > 1 ? (int)__umulhi((unsigned)q, m) : q;
  }
};

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }

// n bytes padded to a multiple of 16
__host__ __device__ inline size_t pad16(size_t n) { return (n + 15) / 16 * 16; }

// Row stride of a staged slab of h, in elements of esz bytes: where a row of
// one type is under 128 bytes the rows are padded by 16 bytes, so that rows
// start on different banks (from 128 bytes on, staggered starts spread the
// lanes instead).
__host__ __device__ inline int row_stride(int T, int cs, int esz) {
  return T * cs + (cs * esz < 128 ? 16 / esz : 0);
}

}  // namespace
