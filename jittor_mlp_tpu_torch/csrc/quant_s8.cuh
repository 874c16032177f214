// Dynamic activation quantization for the W8A8 blocks: the passes that
// write the int8 operands of gemm_s8.cuh and their f32 scales.
//
// Arithmetic of the reference (`_quant_act`, mixer_block_int8.py:53-62):
//   ax = max(absmax, 1e-30); rs = 127 / ax; q = round_half_even(v · rs);
//   scale = ax · f32(1/127)
// The scale is a reduction over the contraction axis of the product that
// consumes q, so it needs the whole axis before any code is written: each
// pass reads its input twice, once for the absmax and once to quantize.
//
// - quant_cols: per image z, per column d, over rows r < R (the token axis
//   or the token-mix hidden axis). Writes q transposed, (B, D, Rp) with Rp
//   a multiple of 32 and zeros in rows R..Rp-1, so the token GEMM's B
//   operand is K-contiguous.
// - quant_rows: per row m and per chunk of ck columns. Writes q as
//   (M, nch, ckp) with ckp a multiple of 32 and zeros past ck in each
//   chunk, and scales (M, nch).
// - row_stats, row_stats_f32: LayerNorm statistics (mean, 1/std) of bf16
//   rows, or of f32 rows at a row stride (the gMLP SGU's v half).
#pragma once

#include "common.cuh"

namespace jmt {
namespace quant {

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ int8_t quantize(float v, float rs) {
  return static_cast<int8_t>(__float2int_rn(__fmul_rn(v, rs)));
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// One warp per row: f32 mean and 1/sqrt(var + eps), two passes. Row r of x
// starts at x + r·ld.
template <class T>
__global__ void row_stats_kernel(const T* __restrict__ x, long long ld,
                                 float2* __restrict__ stats, int rows, int cols, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * ld;
  float s = 0.0f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / cols;
  float v = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / cols + eps);  // every lane shuffles
  if (lane == 0) stats[row] = make_float2(mu, rstd);
}

// Statistics of contiguous bf16 rows.
inline cudaError_t row_stats(cudaStream_t s, const void* x, float2* stats, int rows, int cols) {
  row_stats_kernel<bf16><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(x), cols,
                                                         stats, rows, cols, 1e-5f);
  return cudaGetLastError();
}

// Statistics of f32 rows of `cols`, ld elements apart.
inline cudaError_t row_stats_f32(cudaStream_t s, const float* x, long long ld, float2* stats,
                                 int rows, int cols) {
  row_stats_kernel<float><<<(rows + 7) / 8, 256, 0, s>>>(x, ld, stats, rows, cols, 1e-5f);
  return cudaGetLastError();
}

// LayerNorm of bf16 x, in f32: ((x - mu) · rstd) · w + b. Row r of image z
// is x row z·R + r; `cols` is its length.
struct LnSrc {
  const bf16* x;
  const float2* stats;
  const bf16* w;
  const bf16* b;
  int R, cols;

  __device__ float operator()(long long z, int r, int c) const {
    const long long row = z * R + r;
    const float2 st = stats[row];
    const float n = __fmul_rn(__fsub_rn(__bfloat162float(x[row * cols + c]), st.x), st.y);
    return __fadd_rn(__fmul_rn(n, __bfloat162float(w[c])), __bfloat162float(b[c]));
  }
};

// LayerNorm of f32 rows, in f32: ((x - mu) · rstd) · w + b. Row r of
// image z is row z·R + r of x, ld elements apart; stats from row_stats_f32.
struct LnF32Src {
  const float* x;
  long long ld;
  const float2* stats;
  const bf16* w;
  const bf16* b;
  int R;

  __device__ float operator()(long long z, int r, int c) const {
    const long long row = z * R + r;
    const float2 st = stats[row];
    const float n = __fmul_rn(__fsub_rn(x[row * ld + c], st.x), st.y);
    return __fadd_rn(__fmul_rn(n, __bfloat162float(w[c])), __bfloat162float(b[c]));
  }
};

// An f32 array: v = p[z·sz + r·ld + c].
struct F32Src {
  const float* p;
  long long sz;
  int ld;

  __device__ float operator()(long long z, int r, int c) const {
    return p[z * sz + (long long)r * ld + c];
  }
};

// ResMLP's first affine in f32: x · a[c] + b[c], x bf16 (B, R, cols).
struct AffSrc {
  const bf16* x;
  const bf16* a;
  const bf16* b;
  int R, cols;

  __device__ float operator()(long long z, int r, int c) const {
    const float v = __bfloat162float(x[(z * R + r) * cols + c]);
    return __fadd_rn(__fmul_rn(v, __bfloat162float(a[c])), __bfloat162float(b[c]));
  }
};

constexpr int SLAB = 256;  // rows staged in shared memory at a time

// grid (ceil(D/32), B), block (32, 8): threadIdx.x is the column.
template <class Src>
__global__ void __launch_bounds__(256)
quant_cols_kernel(Src src, int R, int Rp, int D, int8_t* __restrict__ q,
                  float* __restrict__ scale) {
  __shared__ float red[8][33];
  __shared__ int8_t qs[32][SLAB + 4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long z = blockIdx.y;
  const int d0 = blockIdx.x * 32, d = d0 + tx;
  const bool col = d < D;
  float amax = 0.0f;
  if (col)
    for (int r = ty; r < R; r += 8) amax = fmaxf(amax, fabsf(src(z, r, d)));
  red[ty][tx] = amax;
  __syncthreads();
  if (ty == 0) {
    for (int k = 1; k < 8; ++k) amax = fmaxf(amax, red[k][tx]);
    red[0][tx] = amax;
  }
  __syncthreads();
  const float ax = fmaxf(red[0][tx], 1e-30f);
  const float rs = 127.0f / ax;
  if (ty == 0 && col) scale[z * D + d] = __fmul_rn(ax, kInv127);
  for (int r0 = 0; r0 < Rp; r0 += SLAB) {
    const int len = min(SLAB, Rp - r0);
    for (int r = ty; r < len; r += 8)
      qs[tx][r] = (col && r0 + r < R) ? quantize(src(z, r0 + r, d), rs) : 0;
    __syncthreads();
    // coalesced along the row of q: consecutive threads, consecutive bytes
    for (int i = ty * 32 + tx; i < 32 * len; i += 256) {
      const int dl = i / len, r = i % len;
      if (d0 + dl < D) q[(z * D + d0 + dl) * Rp + r0 + r] = qs[dl][r];
    }
    __syncthreads();
  }
}

template <class Src>
cudaError_t quant_cols(cudaStream_t s, const Src& src, int B, int R, int Rp, int D, void* q,
                       float* scale) {
  quant_cols_kernel<Src><<<dim3((D + 31) / 32, B), dim3(32, 8), 0, s>>>(
      src, R, Rp, D, static_cast<int8_t*>(q), scale);
  return cudaGetLastError();
}

// One warp per (row m, chunk j) of an M × (nch·ck) input; src(0, m, c).
template <class Src>
__global__ void quant_rows_kernel(Src src, int M, int nch, int ck, int ckp,
                                  int8_t* __restrict__ q, float* __restrict__ scale) {
  const long long w = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)M * nch) return;
  const int m = static_cast<int>(w / nch), j = static_cast<int>(w % nch);
  const int c0 = j * ck;
  float amax = 0.0f;
  for (int c = lane; c < ck; c += 32) amax = fmaxf(amax, fabsf(src(0, m, c0 + c)));
  const float ax = fmaxf(warp_max(amax), 1e-30f);
  const float rs = 127.0f / ax;
  if (lane == 0) scale[w] = __fmul_rn(ax, kInv127);
  int8_t* qr = q + w * ckp;
  for (int c = lane; c < ckp; c += 32) qr[c] = c < ck ? quantize(src(0, m, c0 + c), rs) : 0;
}

template <class Src>
cudaError_t quant_rows(cudaStream_t s, const Src& src, int M, int nch, int ck, int ckp,
                       void* q, float* scale) {
  const long long warps = (long long)M * nch;
  quant_rows_kernel<Src><<<static_cast<unsigned>((warps + 7) / 8), 256, 0, s>>>(
      src, M, nch, ck, ckp, static_cast<int8_t*>(q), scale);
  return cudaGetLastError();
}

}  // namespace quant
}  // namespace jmt
