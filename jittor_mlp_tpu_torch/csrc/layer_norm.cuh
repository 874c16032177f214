// Row LayerNorm of bf16 activations with f32 statistics and affine, bf16
// out: the bf16 Mixer block's LN1/LN2 and the bf16 gMLP block's LN1 and
// SGU norm (over the v half of each row, hence the row stride).
#pragma once

#include "common.cuh"

namespace jmt {

// One warp per row: f32 two-pass statistics, f32 affine, bf16 store. Row r
// of x starts at x + r·ldx; y is contiguous, rows of `cols`.
__global__ void layer_norm_kernel(const bf16* __restrict__ x, long long ldx,
                                  const bf16* __restrict__ w, const bf16* __restrict__ b,
                                  bf16* __restrict__ y, int rows, int cols, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * ldx;
  bf16* yr = y + (size_t)row * cols;
  float s = 0.0f;
  for (int c = lane; c < cols; c += 32) s += __bfloat162float(xr[c]);
  const float mu = warp_sum(s) / cols;
  float v = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / cols + eps);
  for (int c = lane; c < cols; c += 32) {
    const float n = (__bfloat162float(xr[c]) - mu) * rstd;
    yr[c] = __float2bfloat16(n * __bfloat162float(w[c]) + __bfloat162float(b[c]));
  }
}

// LayerNorm (eps 1e-5) of `rows` rows of `cols` elements, row r of x at
// x + r·ldx, into contiguous y; launched on `stream`.
inline cudaError_t layer_norm(cudaStream_t stream, const void* x, long long ldx, const void* w,
                              const void* b, void* y, int rows, int cols) {
  constexpr int ROWS_PER_BLOCK = 8;
  layer_norm_kernel<<<(rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0,
                      stream>>>(static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(w),
                                static_cast<const bf16*>(b), static_cast<bf16*>(y), rows,
                                cols, 1e-5f);
  return cudaGetLastError();
}

}  // namespace jmt
