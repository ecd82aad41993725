// Helpers shared by typed_mp_fwd.cu and typed_mp_bwd.cu: the aggregator
// codes, 1- and 16-byte loads and stores, cp.async into shared memory, index
// division by one multiply, and the row stride of a staged slab of h.
// ops/fused_mp.py:build rebuilds a library when this header changes.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Agg { AGG_MAX = 0, AGG_SUM = 1, AGG_MEAN = 2, AGG_SOFTMAX = 3 };

constexpr int SMEM_PER_BLOCK = 232448;  // shared memory an H100 block may use

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void load_u8(const uint8_t* p, int* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { p[0] = v[0]; }
  __device__ static void store_u8(uint8_t* p, const int* v) { p[0] = (uint8_t)v[0]; }
  // shared memory
  __device__ static void lds(const float* p, float* v) { v[0] = p[0]; }
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
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Row stride of a staged slab of h, in words: below 32 channels the rows
// are padded by 16 bytes, so that rows start on different banks (from 32
// on, staggered starts spread the lanes instead).
__host__ __device__ inline int row_stride(int T, int cs) {
  return T * cs + (cs < 32 ? 4 : 0);
}

}  // namespace
