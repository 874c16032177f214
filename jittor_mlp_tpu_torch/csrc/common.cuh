// Device helpers shared by the port's kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace jmt {

typedef __nv_bfloat16 bf16;

// The Hendrycks tanh form of GELU, in f32 (the bf16 paths' activation),
//   0.5·x·(1 + tanh u),  u = √(2/π)·(x + 0.044715·x³),
// evaluated as the identity x·σ(2u) = x / (1 + 2^a), a = −2·log2(e)·u, on
// the special-function unit: one ex2.approx and one rcp.approx (MUFU.EX2,
// MUFU.RCP) and four FMA-pipe operations, where libm's tanhf is about 45
// branchy instructions a value. The TPU kernels this ports take their tanh
// from the VPU's hardware tanh (jittor_mlp_tpu/ops/pallas/mixer_block.py:
// 47-57); a libm tanh in a product's epilogue bounds the epilogue instead
// (the Mixer GELU channel product: 0.458 ms against 0.343 without the call,
// on an H100 80GB HBM3 at 700 W). Not tanh.approx.f32: its relative error
// of about 2^-11 on tanh u cancels in 1 + tanh u as x goes negative (about
// 20% of the GELU near x = −3); the sigmoid form has no cancellation
// (libm's form cancels too: 1 + tanhf(u) keeps tanhf's absolute error near
// −1, relative 1.3e-5 at x = −3 and 30% at x = −5).
//
// Error against the tanh form evaluated in float64 (through the same
// identity, since 1 + tanh u cancels in float64 too below x ≈ −6), with
// ε = 2^-24 (f32 rounding): a = x·fma(x², C3, C1) carries ≤ 3.33ε of
// relative error (x², the fma, the product, and the f32 constants' 0.33ε
// and 0.09ε), which 2^a turns into ln2·3.33ε·|a| of relative error;
// ex2.approx adds ≤ 2 ulp (2^-22), 1 + 2^a ε, rcp.approx 1 ulp (2^-23),
// the last product ε. So the relative error is at most
//   (3.33·ln2·|a| + 2)·2^-24 + 3·2^-23 ≤ 1.8e-5
// wherever 1 + 2^a < 2^126 (x > −10.0; 1.9e-6 for x > −3, |a| < 10);
// below x = −10.0 the .ftz reciprocal (or 2^a's overflow) gives ±0, and the
// GELU there is below 1.2e-37 in magnitude. Special values follow the tanh
// form: +∞ → +∞, −∞ → NaN (0.5·(−∞)·0), NaN → NaN, ±0 → ±0, and a finite x
// whose x³ overflows gives x (x > 0) or −0.
constexpr float GELU_C1 = -2.302208198144325f;    // −2·log2(e)·√(2/π)
constexpr float GELU_C3 = -0.1029432395800235f;   // GELU_C1 · 0.044715
__device__ __forceinline__ float gelu_tanh(float x) {
  const float a = x * fmaf(x * x, GELU_C3, GELU_C1);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return x * r;
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
