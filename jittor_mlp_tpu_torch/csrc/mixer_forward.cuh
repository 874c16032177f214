// The bf16 Mixer block forward as the launches of one stream: the body of
// mixer_block.cu's entries and of mixer_block_bwd.cu's forward-with-h (see
// mixer_block.cu's header for the math and what bounds it), and the token
// products the kernel lab's bodies share with it. All four products run on
// the Hopper core (gemm_sm90.cuh) where TMA can load their operands, else on
// the WMMA core (gemm_bf16.cuh) with the same arguments.
#pragma once

#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

namespace jmt {

// The token mix's two products over nz entries of W columns each, the
// weights shared by every entry and the entries N-major B operands (the
// core's TB mode). Wt1 (TD, N) is first copied into wt1p, rows of
// round_up(N, 8) (16-byte multiples, which a TMA load can stride), zero
// past column N. Then
//   epi1(z, Wt1 · xn_z)   K = N tokens; xn_z at xn + z·sx, rows ldx apart
//   epi2(z, Wt2 · t_z)    M = N tokens (192 + 4 rows at 196); t_z at
//                         t + z·st, rows ldt apart: what epi1 wrote
// Kernel 1 runs an entry an image (W = D); the kernel lab's wide and
// token-major bodies an entry a group of bt images side by side (W = bt·D).
// Returns a cudaError_t code (0 on success) from the first call that failed.
template <class Epi1, class Epi2>
inline int token_products(cudaStream_t s, int nz, int N, int W, int TD, const void* wt1,
                          void* wt1p, const void* xn, int ldx, long long sx, const void* wt2,
                          const void* t, int ldt, long long st, const Epi1& epi1,
                          const Epi2& epi2) {
  const int Np = round_up(N, 8);
  JMT_CHECK(cudaMemsetAsync(wt1p, 0, sizeof(bf16) * TD * Np, s));
  JMT_CHECK(cudaMemcpy2DAsync(wt1p, sizeof(bf16) * Np, wt1, sizeof(bf16) * N, sizeof(bf16) * N,
                              TD, cudaMemcpyDeviceToDevice, s));
  JMT_CHECK((sm90::gemm_bf16<false, true>(s, nz, TD, W, N, N, wt1p, Np, 0, xn, ldx, sx, epi1)));
  JMT_CHECK((sm90::gemm_bf16<false, true>(s, nz, N, W, TD, TD, wt2, TD, 0, t, ldt, st, epi2)));
  return 0;
}

// Everything up to the channel mix's hidden activations. All pointers are
// contiguous bf16 device buffers. Scratch: xn (B, N, D), reused for hn;
// t (B, TD, D); wt1p (TD, round_up(N, 8)), Wt1 in rows a TMA load can
// stride (16-byte multiples), zero past column N. h (B, N, D) is the
// channel mix's input and c (B·N, CD) its hidden activations, left for the
// caller. Returns a cudaError_t code (0 on success) from the first call
// that failed.
inline int mixer_forward_hidden(cudaStream_t s, const void* x, const void* ln1w,
                                const void* ln1b, const void* wt1, const void* bt1,
                                const void* wt2, const void* bt2, const void* ln2w,
                                const void* ln2b, const void* wc1, const void* bc1, void* xn,
                                void* t, void* wt1p, void* h, void* c, int B, int N, int D,
                                int TD, int CD) {
  using bf16gemm::gelu_bias;
  using bf16gemm::residual_bias;
  const long long nd = (long long)N * D, td = (long long)TD * D;
  JMT_CHECK(layer_norm(s, x, D, ln1w, ln1b, xn, B * N, D));
  // token mix, an entry an image: t = gelu(Wt1 · xn + bt1); h = x + Wt2 · t + bt2
  if (const int e = token_products(s, B, N, D, TD, wt1, wt1p, xn, D, nd, wt2, t, D, td,
                                   gelu_bias(bt1, 1, t, D, td),
                                   residual_bias(bt2, 1, x, h, D, nd)))
    return e;
  JMT_CHECK(layer_norm(s, h, D, ln2w, ln2b, xn, B * N, D));
  // channel mix over all B·N rows: c = gelu(hn · Wc1^T + bc1)
  JMT_CHECK(sm90::gemm_tn(s, B * N, CD, D, xn, D, wc1, D, gelu_bias(bc1, 0, c, CD, 0)));
  return 0;
}

// The whole block: the above, then out = h + c · Wc2^T + bc2.
inline int mixer_forward(cudaStream_t s, const void* x, const void* ln1w, const void* ln1b,
                         const void* wt1, const void* bt1, const void* wt2, const void* bt2,
                         const void* ln2w, const void* ln2b, const void* wc1, const void* bc1,
                         const void* wc2, const void* bc2, void* xn, void* t, void* wt1p,
                         void* h, void* c, void* out, int B, int N, int D, int TD, int CD) {
  const int e = mixer_forward_hidden(s, x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1,
                                     xn, t, wt1p, h, c, B, N, D, TD, CD);
  if (e) return e;
  JMT_CHECK(sm90::gemm_tn(s, B * N, D, CD, c, CD, wc2, CD,
                          bf16gemm::residual_bias(bc2, 0, h, out, D, 0)));
  return 0;
}

}  // namespace jmt
