// Device helpers shared by the port's kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace jmt {

typedef __nv_bfloat16 bf16;

// The Hendrycks tanh form of GELU, in f32 (the bf16 paths' activation).
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global → shared copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Eight f32 values at p as two 16-byte accesses.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// p[n .. n+7] of a per-column bf16 vector (n % 8 == 0), packed as in
// memory: one 16-byte load where p is aligned. Read them with at8, so that
// a functor can issue every load of a row before it waits on any.
__device__ __forceinline__ uint4 col8(const bf16* p, int n) {
  if (aligned16(p)) return *reinterpret_cast<const uint4*>(p + n);
  uint4 r;
  bf16* rv = reinterpret_cast<bf16*>(&r);
  for (int e = 0; e < 8; ++e) rv[e] = p[n + e];
  return r;
}

// Element e of eight packed bf16 values, in f32.
__device__ __forceinline__ float at8(const uint4& r, int e) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&r)[e]);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight values rounded to bf16 as one 16-byte store.
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 out;
  bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) ov[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(p) = out;
}

// Whether a buffer allows 16-byte access of rows ld elements apart, batch
// entries stride elements apart (elem bytes each).
inline bool vec_ok(const void* p, long long ld, long long stride, int elem = 2) {
  const long long per16 = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % per16 == 0 && stride % per16 == 0;
}

// Carves a workspace into 256-byte-aligned buffers. With base nullptr it
// only counts: `bytes` is then the size to allocate.
struct Carver {
  char* base;
  size_t bytes = 0;

  template <class T>
  T* take(size_t n) {
    bytes = (bytes + 255) & ~size_t(255);
    T* p = base ? reinterpret_cast<T*>(base + bytes) : nullptr;
    bytes += n * sizeof(T);
    return p;
  }
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace jmt

#define JMT_CHECK(call)                    \
  do {                                     \
    cudaError_t e_ = (call);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
