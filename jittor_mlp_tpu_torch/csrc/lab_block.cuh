// Epilogues and a LayerNorm for the kernel lab's Mixer-block variants
// (lab_tokmajor.cu, lab_wide.cu, lab_ablate.cu): the
// activations the lab ablates, the residual order of its bodies, the
// token-major variant's bf16 + f32 store of h and the wide variant's
// scatter of h back to (B, N, D). All four products of each body run
// through kernel 1's code: the token pair through mixer_forward.cuh's
// token_products, the channel pair through gemm_tn, so on gemm_sm90.cuh's
// wgmma core where TMA can load the operands, else on gemm_bf16.cuh's WMMA
// core. Both cores call an epilogue as gemm_bf16.cuh states: row m < M,
// columns n .. n+cnt−1 < N with n % 8 == 0 and cnt ≤ 8.
#pragma once

#include "mixer_forward.cuh"

namespace jmt {
namespace lab {

// The ablate kernel's activation codes (ops/kernels/kernel_lab.py GELUS).
enum class Act { Exact = 0, Fast3 = 1, Tanh = 2, Relu = 3 };

template <Act A>
__device__ __forceinline__ float act(float z) {
  if constexpr (A == Act::Exact) {
    return 0.5f * z * (1.0f + erff(z * 0.7071067811865476f));
  } else if constexpr (A == Act::Fast3) {  // A&S 7.1.25, the lab's constants
    const float a = fabsf(z) * 0.7071067811865476f;
    const float t = 1.0f / (1.0f + 0.47047f * a);
    const float poly = t * (0.3480242f + t * (-0.0958798f + t * 0.7478556f));
    const float e = 1.0f - poly * expf(-a * a);
    return 0.5f * z * (1.0f + (z > 0.0f ? e : (z < 0.0f ? -e : 0.0f)));
  } else if constexpr (A == Act::Tanh) {
    return gelu_tanh(z);
  } else {
    return fmaxf(z, 0.0f);
  }
}

// C = bf16(act(acc + bias)); bias per row of C (token mix) or per column
// (channel mix). vec: C allows 16-byte stores.
template <Act A>
struct ActBias {
  const bf16* bias;
  int per_row;
  bf16* C;
  int ldc;
  long long sC;
  bool vec;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const size_t o = z * sC + (size_t)m * ldc + n;
    const float brow = per_row ? __bfloat162float(bias[m]) : 0.0f;
    if (vec && cnt == 8) {
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ov[e] = __float2bfloat16(act<A>(v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
      *reinterpret_cast<uint4*>(C + o) = out;
    } else {
      for (int e = 0; e < cnt; ++e)
        C[o + e] =
            __float2bfloat16(act<A>(v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
    }
  }
};

template <Act A>
inline ActBias<A> act_bias(const void* bias, int per_row, void* C, int ldc, long long sC) {
  return {static_cast<const bf16*>(bias), per_row, static_cast<bf16*>(C), ldc, sC,
          vec_ok(C, ldc, sC)};
}

// The second token product's residual, in the lab bodies' order:
// hf = (R + acc) + bias[m] in f32, C = bf16(hf), and where Cf is given
// Cf = hf (the token-major body's LN2 reads the f32 h). R, C and Cf share
// one layout. vec: all allow 16-byte access.
struct TokenResidual {
  const bf16* bias;
  const bf16* R;
  bf16* C;
  float* Cf;
  int ldc;
  long long sC;
  bool vec;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const size_t o = z * sC + (size_t)m * ldc + n;
    const float b = __bfloat162float(bias[m]);
    if (vec && cnt == 8) {
      const uint4 res = *reinterpret_cast<const uint4*>(R + o);
      const bf16* rv = reinterpret_cast<const bf16*>(&res);
      float hf[8];
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        hf[e] = (__bfloat162float(rv[e]) + v[e]) + b;
        ov[e] = __float2bfloat16(hf[e]);
      }
      *reinterpret_cast<uint4*>(C + o) = out;
      if (Cf) {
        reinterpret_cast<float4*>(Cf + o)[0] = make_float4(hf[0], hf[1], hf[2], hf[3]);
        reinterpret_cast<float4*>(Cf + o)[1] = make_float4(hf[4], hf[5], hf[6], hf[7]);
      }
    } else {
      for (int e = 0; e < cnt; ++e) {
        const float hf = (__bfloat162float(R[o + e]) + v[e]) + b;
        C[o + e] = __float2bfloat16(hf);
        if (Cf) Cf[o + e] = hf;
      }
    }
  }
};

inline TokenResidual token_residual(const void* bias, const void* R, void* C, float* Cf, int ldc,
                                    long long sC) {
  return {static_cast<const bf16*>(bias), static_cast<const bf16*>(R), static_cast<bf16*>(C), Cf,
          ldc, sC,
          vec_ok(C, ldc, sC) && vec_ok(R, ldc, sC) && (!Cf || vec_ok(Cf, ldc, sC, 4))};
}

// The wide body's second token product: group z holds images z·bt ..
// z·bt + bt − 1 side by side, column c = i·D + d of the group's product is
// element d of image z·bt + i. h = bf16(x + (acc + bias[m])) goes back to
// the (B, N, D) layout of x and h. vec: D % 8 == 0 (so 8 columns from a
// multiple of 8 lie in one image) and x, h allow 16-byte access. Else eight
// columns may straddle two images (D = 30, bt = 4: the wgmma core's route,
// as bt·D % 8 == 0), and each column finds its own image.
struct ScatterResidual {
  const bf16* bias;
  const bf16* R;
  bf16* C;
  int N, D, bt;
  bool vec;

  __device__ size_t at(long long z, int m, int c) const {
    return ((size_t)(z * bt + c / D) * N + m) * D + c % D;
  }

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const float b = __bfloat162float(bias[m]);
    if (vec && cnt == 8) {
      const size_t o = at(z, m, n);
      const uint4 res = *reinterpret_cast<const uint4*>(R + o);
      const bf16* rv = reinterpret_cast<const bf16*>(&res);
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) ov[e] = __float2bfloat16(__bfloat162float(rv[e]) + (v[e] + b));
      *reinterpret_cast<uint4*>(C + o) = out;
    } else {
      for (int e = 0; e < cnt; ++e) {
        const size_t o = at(z, m, n + e);
        C[o] = __float2bfloat16(__bfloat162float(R[o]) + (v[e] + b));
      }
    }
  }
};

inline ScatterResidual scatter_residual(const void* bias, const void* R, void* C, int N, int D,
                                        int bt) {
  return {static_cast<const bf16*>(bias), static_cast<const bf16*>(R), static_cast<bf16*>(C), N, D,
          bt, D % 8 == 0 && vec_ok(R, D, 0) && vec_ok(C, D, 0)};
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// layer_norm.cuh's row LayerNorm (one warp a row, f32 two-pass statistics
// and affine, bf16 out) from bf16 or f32 rows of a (B, N, D) array, each
// row (b, n) stored at row ((b / bt)·N + n)·bt + b % bt of y: the
// (B/bt, N, bt, D) group layout. bt = 1 keeps the rows in place.
template <class T>
__global__ void layer_norm_grouped_kernel(const T* __restrict__ x, const bf16* __restrict__ w,
                                          const bf16* __restrict__ b, bf16* __restrict__ y,
                                          int rows, int cols, int ntok, int bt, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  const int img = row / ntok, tok = row % ntok;
  bf16* yr = y + (((size_t)(img / bt) * ntok + tok) * bt + img % bt) * cols;
  float s = 0.0f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / cols;
  float v = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / cols + eps);
  for (int c = lane; c < cols; c += 32) {
    const float n = (to_f32(xr[c]) - mu) * rstd;
    yr[c] = __float2bfloat16(n * __bfloat162float(w[c]) + __bfloat162float(b[c]));
  }
}

// LayerNorm (eps 1e-5) of `rows` contiguous rows of `cols` elements of x
// (bf16 or float), rows of ntok tokens per image, into y in the group
// layout of bt images; launched on `stream`.
template <class T>
cudaError_t layer_norm_grouped(cudaStream_t stream, const T* x, const void* w, const void* b,
                               void* y, int rows, int cols, int ntok, int bt) {
  constexpr int ROWS_PER_BLOCK = 8;
  layer_norm_grouped_kernel<T><<<(rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                                 ROWS_PER_BLOCK * 32, 0, stream>>>(
      x, static_cast<const bf16*>(w), static_cast<const bf16*>(b), static_cast<bf16*>(y), rows,
      cols, ntok, bt, 1e-5f);
  return cudaGetLastError();
}

}  // namespace lab
}  // namespace jmt
