// ResMLP block forward in bf16 for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/resmlp_block.py::
// fused_resmlp_block (body `_kernel`). For x (B, N, D), with the same
// rounding points:
//   h   = bf16(x · α1 + β1)                                  f32 affine
//   h2  = (h + γ1 · (Wt · h + bt)) · α2 + β2                  f32, Wt (N, N)
//   c   = bf16(gelu_tanh(bf16(h2) · W1ᵀ + c1))               W1 (F, D)
//   out = bf16(h2 + γ2 · (c · W2ᵀ + c2))                      W2 (D, F)
// The last residual takes h2 in f32, as the TPU kernel keeps it; the FF
// takes it rounded to bf16. All products accumulate in f32 on the tensor
// cores, on the Mixer block's GEMM (gemm_bf16.cuh) with ResMLP epilogues.
//
// What bounds it on this card, and what the design does about it:
// - 2·B·N·(N·D + 2·D·F) flops: 125.9 G at b256 for ResMLP-S24 (N = 196,
//   D = 384, F = 1536), 0.127 ms at the data sheet's 989 dense bf16 TFLOP/s.
//   The two FF products carry 94% of them and stack all B·N rows into one M.
// - No VMEM: the block is four launches (affine, token GEMM, FF1, FF2);
//   h, h2 (f32 and bf16) and c go through device memory; the weights are
//   shared by every image and stay in L2.
// - The token product is per image with K = M = N = 196, ragged: K tails
//   are zero-filled in shared memory, M edges masked in the epilogue; Wt's
//   392-byte rows take the 2-byte load path.

#include <algorithm>

#include "gemm_bf16.cuh"

using namespace jmt;

namespace {

// h = bf16(x · α1 + β1), α1 / β1 per column of (rows, D).
__global__ void affine_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                              const bf16* __restrict__ b, bf16* __restrict__ y, long long n,
                              int D) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = static_cast<int>(i % D);
    y[i] = __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(x[i]), __bfloat162float(a[c])),
                                      __bfloat162float(b[c])));
  }
}

// Token-mix epilogue at (z, m, n) of (B, N, D):
//   h2 = (h + γ1 · (v + bt[m])) · α2 + β2, stored in f32 and as bf16.
struct TokenAffine {
  const bf16* h;
  const bf16* bt;
  const bf16* g1;
  const bf16* a2;
  const bf16* b2;
  float* h2;
  bf16* h2b;
  int D;
  long long sz;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const long long o = z * sz + (long long)m * D + n;
    const float b = __bfloat162float(bt[m]);
    for (int e = 0; e < cnt; ++e) {
      const int c = n + e;
      const float t = __fadd_rn(v[e], b);
      const float hh = __fadd_rn(__bfloat162float(h[o + e]), __fmul_rn(__bfloat162float(g1[c]), t));
      const float y = __fadd_rn(__fmul_rn(hh, __bfloat162float(a2[c])), __bfloat162float(b2[c]));
      h2[o + e] = y;
      h2b[o + e] = __float2bfloat16(y);
    }
  }
};

// Output epilogue: out = bf16(h2 + γ2 · (v + c2)), (B·N, D).
struct ScaledResid {
  const float* h2;
  const bf16* g2;
  const bf16* c2;
  bf16* out;
  int D;

  __device__ void operator()(long long, int m, int n, const float* v, int cnt) const {
    for (int e = 0; e < cnt; ++e) {
      const long long o = (long long)m * D + n + e;
      const float f = __fadd_rn(v[e], __bfloat162float(c2[n + e]));
      out[o] = __float2bfloat16(__fadd_rn(h2[o], __fmul_rn(__bfloat162float(g2[n + e]), f)));
    }
  }
};

struct Work {
  bf16* h;
  float* h2;
  bf16* h2b;
  bf16* c;

  Work(Carver& w, int B, int N, int D, int F) {
    const size_t md = (size_t)B * N * D;
    h = w.take<bf16>(md);
    h2 = w.take<float>(md);
    h2b = w.take<bf16>(md);
    c = w.take<bf16>((size_t)B * N * F);
  }
};

}  // namespace

// Bytes of device workspace resmlp_block_bf16 needs.
extern "C" size_t resmlp_block_bf16_workspace(int B, int N, int D, int F) {
  Carver counter{nullptr};
  const Work work(counter, B, N, D, F);
  (void)work;
  return counter.bytes;
}

// All tensors bf16, contiguous, affines flattened to (D,): x (B, N, D),
// wt (N, N), w1 (F, D), w2 (D, F). ws: resmlp_block_bf16_workspace bytes.
// Returns a cudaError_t code (0 on success) from the first launch that
// failed.
extern "C" int resmlp_block_bf16(const void* x, const void* a1, const void* b1, const void* g1,
                                 const void* wt, const void* bt, const void* a2, const void* b2,
                                 const void* g2, const void* w1, const void* c1, const void* w2,
                                 const void* c2, void* ws, void* out, int B, int N, int D, int F,
                                 void* stream_ptr) {
  using bf16gemm::gelu_bias;
  using bf16gemm::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  Carver carver{static_cast<char*>(ws)};
  const Work w(carver, B, N, D, F);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  const long long nd = (long long)N * D, md = (long long)B * nd;
  const int M = B * N;

  affine_kernel<<<static_cast<unsigned>(std::min<long long>((md + 255) / 256, 8192)), 256, 0,
                  s>>>(bf(x), bf(a1), bf(b1), w.h, md, D);
  JMT_CHECK(cudaGetLastError());
  // token mix, per image
  JMT_CHECK(gemm<false>(s, B, N, D, N, wt, N, 0, w.h, D, nd,
                        TokenAffine{w.h, bf(bt), bf(g1), bf(a2), bf(b2), w.h2, w.h2b, D, nd}));
  // channel FF over all B·N rows
  JMT_CHECK(gemm<true>(s, 1, M, F, D, w.h2b, D, 0, w1, D, 0, gelu_bias(c1, 0, w.c, F, 0)));
  JMT_CHECK(gemm<true>(s, 1, M, D, F, w.c, F, 0, w2, F, 0,
                       ScaledResid{w.h2, bf(g2), bf(c2), static_cast<bf16*>(out), D}));
  return 0;
}

extern "C" const char* resmlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
