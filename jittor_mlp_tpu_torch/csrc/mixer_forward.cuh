// The bf16 Mixer block forward as six launches on one stream: the body of
// mixer_block.cu's entry and of mixer_block_bwd.cu's forward-with-h (see
// mixer_block.cu's header for the math and what bounds it). The channel
// products run on the Hopper core (gemm_sm90.cuh) where TMA can load their
// operands, the token products on the WMMA core (gemm_bf16.cuh).
#pragma once

#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

namespace jmt {

// All pointers are contiguous bf16 device buffers. Scratch: xn (B, N, D),
// reused for hn; t (B, TD, D); c (B·N, CD). h (B, N, D) is the channel
// mix's input, left for the caller. Returns a cudaError_t code (0 on
// success) from the first launch that failed.
inline int mixer_forward(cudaStream_t s, const void* x, const void* ln1w, const void* ln1b,
                         const void* wt1, const void* bt1, const void* wt2, const void* bt2,
                         const void* ln2w, const void* ln2b, const void* wc1, const void* bc1,
                         const void* wc2, const void* bc2, void* xn, void* t, void* h, void* c,
                         void* out, int B, int N, int D, int TD, int CD) {
  using bf16gemm::gelu_bias;
  using bf16gemm::gemm;
  using bf16gemm::residual_bias;
  const long long nd = (long long)N * D, td = (long long)TD * D;
  JMT_CHECK(layer_norm(s, x, D, ln1w, ln1b, xn, B * N, D));
  // token mix, per image: t = gelu(Wt1 · xn + bt1); h = x + Wt2 · t + bt2
  JMT_CHECK(gemm<false>(s, B, TD, D, N, wt1, N, 0, xn, D, nd, gelu_bias(bt1, 1, t, D, td)));
  JMT_CHECK(gemm<false>(s, B, N, D, TD, wt2, TD, 0, t, D, td,
                        residual_bias(bt2, 1, x, h, D, nd)));
  JMT_CHECK(layer_norm(s, h, D, ln2w, ln2b, xn, B * N, D));
  // channel mix over all B·N rows: c = gelu(hn · Wc1^T + bc1); out = h + c · Wc2^T + bc2
  JMT_CHECK(sm90::gemm_tn(s, B * N, CD, D, xn, D, wc1, D, gelu_bias(bc1, 0, c, CD, 0)));
  JMT_CHECK(sm90::gemm_tn(s, B * N, D, CD, c, CD, wc2, CD, residual_bias(bc2, 0, h, out, D, 0)));
  return 0;
}

}  // namespace jmt
