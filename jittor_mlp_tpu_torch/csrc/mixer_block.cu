// Mixer block forward in bf16 for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/mixer_block.py::
// fused_mixer_block (body `_kernel`). For x (B, N, D) it computes, with the
// same rounding points:
//   xn  = bf16(LN1(x))                                  f32 stats and affine
//   t   = bf16(gelu_tanh(Wt1 · xn + bt1))               Wt1 (TD, N), per image
//   h   = bf16(x + Wt2 · t + bt2)                       Wt2 (N, TD), per image
//   hn  = bf16(LN2(h))
//   c   = bf16(gelu_tanh(hn · Wc1^T + bc1))             Wc1 (CD, D), rows B·N
//   out = bf16(h + c · Wc2^T + bc2)                     Wc2 (D, CD)
// All products accumulate in f32 on the tensor cores (gemm_bf16.cuh).
//
// What bounds it on this card, and what the design does about it:
// - The TPU kernel keeps all four weight matrices in VMEM. Here Wc1 alone is
//   4.7 MB in bf16, far beyond a block's 227 KB of shared memory, so the
//   block runs as six launches on the caller's stream: LN, GEMM, GEMM, LN,
//   GEMM, GEMM. Intermediates (xn/hn, t, h, c) go through device memory; the
//   weights are shared by every image (batch stride 0) and stay in the 50 MB
//   L2 cache.
// - The channel GEMMs carry CD/(CD+TD) = 3072/3456 ≈ 89% of the FLOPs. They
//   stack all B·N rows into one M, so at serving batch sizes they are large,
//   compute-bound products: 128×128 output tiles reuse each loaded operand
//   128 times.
// - The token GEMMs (K = N = 196 and K = TD = 384) are small per image and
//   bandwidth-bound at this design: each reads and writes a whole (B, TD, D)
//   intermediate. They run batched over images (grid z) with the weight as
//   the shared A operand.
// - N = 196 is not a multiple of any tile size. It is the K of the first
//   token GEMM and the M of the second: ragged K tails are zero-filled in
//   shared memory and ragged M/N edges are masked in the epilogue, instead
//   of the TPU version's padding to 128.
// - Rows of Wt1 (384, 196) are 392 bytes apart, not 16-byte aligned. The
//   tile loader uses 16-byte cp.async copies only where the base, leading
//   dimension and batch stride allow it, and 2-byte loads elsewhere. Two
//   shared-memory stages let the copies of the next K step overlap the
//   tensor-core work of this one.
// wgmma, TMA and keeping the intermediates on chip are later work.

#include "gemm_bf16.cuh"

using namespace jmt;

namespace {

// C = bf16(R + (acc + bias)); R has C's layout. vec: C and R allow 16-byte
// access.
struct ResidualBias {
  const bf16* bias;
  int per_row;
  const bf16* R;
  bf16* C;
  int ldc;
  long long sC;
  bool vec;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const size_t o = z * sC + (size_t)m * ldc + n;
    const float brow = per_row ? __bfloat162float(bias[m]) : 0.0f;
    if (vec && cnt == 8) {  // one 16-byte residual load, one 16-byte store
      const uint4 res = *reinterpret_cast<const uint4*>(R + o);
      const bf16* rv = reinterpret_cast<const bf16*>(&res);
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ov[e] = __float2bfloat16(__bfloat162float(rv[e]) +
                                 (v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
      *reinterpret_cast<uint4*>(C + o) = out;
    } else {
      for (int e = 0; e < cnt; ++e)
        C[o + e] = __float2bfloat16(__bfloat162float(R[o + e]) +
                                    (v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
    }
  }
};

// One warp per row: f32 two-pass statistics, f32 affine, bf16 store.
__global__ void layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                  const bf16* __restrict__ b, bf16* __restrict__ y,
                                  int rows, int cols, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * cols;
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

cudaError_t layer_norm(cudaStream_t stream, const void* x, const void* w, const void* b,
                       void* y, int rows, int cols) {
  constexpr int ROWS_PER_BLOCK = 8;
  layer_norm_kernel<<<(rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0,
                      stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                static_cast<const bf16*>(b), static_cast<bf16*>(y), rows,
                                cols, 1e-5f);
  return cudaGetLastError();
}

ResidualBias residual_bias(const void* bias, int per_row, const void* R, void* C, int ldc,
                           long long sC) {
  return {static_cast<const bf16*>(bias), per_row, static_cast<const bf16*>(R),
          static_cast<bf16*>(C), ldc, sC, vec_ok(C, ldc, sC) && vec_ok(R, ldc, sC)};
}

}  // namespace

// All pointers are contiguous bf16 device buffers. Scratch: xn (B, N, D),
// reused for hn; t (B, TD, D); h (B, N, D); c (B·N, CD). Returns a
// cudaError_t code (0 on success) from the first launch that failed.
extern "C" int mixer_block_bf16(const void* x, const void* ln1w, const void* ln1b,
                                const void* wt1, const void* bt1, const void* wt2,
                                const void* bt2, const void* ln2w, const void* ln2b,
                                const void* wc1, const void* bc1, const void* wc2,
                                const void* bc2, void* xn, void* t, void* h, void* c,
                                void* out, int B, int N, int D, int TD, int CD,
                                void* stream_ptr) {
  using bf16gemm::gelu_bias;
  using bf16gemm::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const long long nd = (long long)N * D, td = (long long)TD * D;
  JMT_CHECK(layer_norm(s, x, ln1w, ln1b, xn, B * N, D));
  // token mix, per image: t = gelu(Wt1 · xn + bt1); h = x + Wt2 · t + bt2
  JMT_CHECK(gemm<false>(s, B, TD, D, N, wt1, N, 0, xn, D, nd, gelu_bias(bt1, 1, t, D, td)));
  JMT_CHECK(gemm<false>(s, B, N, D, TD, wt2, TD, 0, t, D, td,
                        residual_bias(bt2, 1, x, h, D, nd)));
  JMT_CHECK(layer_norm(s, h, ln2w, ln2b, xn, B * N, D));
  // channel mix over all B·N rows: c = gelu(hn · Wc1^T + bc1); out = h + c · Wc2^T + bc2
  JMT_CHECK(gemm<true>(s, 1, B * N, CD, D, xn, D, 0, wc1, D, 0, gelu_bias(bc1, 0, c, CD, 0)));
  JMT_CHECK(gemm<true>(s, 1, B * N, D, CD, c, CD, 0, wc2, CD, 0,
                       residual_bias(bc2, 0, h, out, D, 0)));
  return 0;
}

extern "C" const char* mixer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
