// The kernel lab's wide Mixer block in bf16 for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel tools/kernel_lab.py::_call with the body
// `_kernel_wide`. For x (B, N, D) and groups of bt images (G = B / bt),
// with the same rounding points and addition order as that body:
//   xg  = bf16(LN1(x))                          written group-major, (G, N, bt·D)
//   t   = bf16(gelu_tanh(Wt1 · xg_g + bt1))     one (N, bt·D) product per group
//   h   = bf16(x + (Wt2 · t + bt2))             the bias added to the product first
//   hn  = bf16(LN2(h))
//   c   = bf16(gelu_tanh(hn · Wc1^T + bc1))     all B·N rows
//   out = bf16(h + (c · Wc2^T + bc2))
// Products accumulate in f32 on the tensor cores, all four through kernel
// 1's code (mixer_forward.cuh's token_products, gemm_tn): on gemm_sm90.cuh's
// wgmma core where TMA can load the operands, else on gemm_bf16.cuh's WMMA
// core. At bt = 2 every rounding point and every sum's K order is kernel
// 1's, so the output equals kernel 1's bit for bit.
//
// What bounds it on this card, and what the design does about it:
// - The channel GEMMs, as in kernel 1 (mixer_block.cu), carry 89% of the
//   FLOPs and are compute-bound.
// - The TPU body relays LN1's output to (N, bt·D) inside the kernel. Here
//   LN1 writes it there directly: the relayout is only its output index, so
//   xg costs no extra pass. Each group is one entry of the token products,
//   W = bt·D columns, xg_g and t_g N-major B operands at leading dimension
//   W (Wt1 copied into rows of round_up(N, 8), shared). Tiles of the wide
//   product may straddle two images when D is not a multiple of 192; the
//   buffer is physical, so the GEMM's loads do not care. TMA needs W % 8 ==
//   0 (and TD % 8 == 0 for the second product); else those products take
//   the WMMA core.
// - The second token product's epilogue scatters h back to (B, N, D)
//   through the column → (image, d) map, 16 bytes at a time where D is a
//   multiple of 8, so LN2 and the channel mix read the native layout.
// Keeping the intermediates on chip is later work.

#include "lab_block.cuh"

using namespace jmt;

// All pointers are contiguous bf16 device buffers. Scratch: xg (G, N, bt·D),
// reused for hn (B, N, D); t (G, TD, bt·D); wt1p (TD, round_up(N, 8)), Wt1
// in rows a TMA load can stride; h (B, N, D); c (B·N, CD).
// Returns a cudaError_t code (0 on success) from the first launch that failed.
extern "C" int lab_wide_bf16(const void* x, const void* ln1w, const void* ln1b, const void* wt1,
                             const void* bt1, const void* wt2, const void* bt2, const void* ln2w,
                             const void* ln2b, const void* wc1, const void* bc1, const void* wc2,
                             const void* bc2, void* xg, void* t, void* wt1p, void* h, void* c,
                             void* out, int B, int N, int D, int TD, int CD, int bt,
                             void* stream_ptr) {
  using bf16gemm::gelu_bias;
  using bf16gemm::residual_bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const int G = B / bt, W = bt * D;
  const long long nw = (long long)N * W, tw = (long long)TD * W;
  JMT_CHECK(lab::layer_norm_grouped(s, static_cast<const bf16*>(x), ln1w, ln1b, xg, B * N, D, N,
                                    bt));
  // token mix, an entry a group: t = gelu(Wt1 · xg_g + bt1); h = x + (Wt2 · t + bt2), scattered
  if (const int e = token_products(s, G, N, W, TD, wt1, wt1p, xg, W, nw, wt2, t, W, tw,
                                   gelu_bias(bt1, 1, t, W, tw),
                                   lab::scatter_residual(bt2, x, h, N, D, bt)))
    return e;
  JMT_CHECK(layer_norm(s, h, D, ln2w, ln2b, xg, B * N, D));
  // channel mix over all B·N rows: c = gelu(hn · Wc1^T + bc1); out = h + c · Wc2^T + bc2
  JMT_CHECK(sm90::gemm_tn(s, B * N, CD, D, xg, D, wc1, D, gelu_bias(bc1, 0, c, CD, 0)));
  JMT_CHECK(sm90::gemm_tn(s, B * N, D, CD, c, CD, wc2, CD, residual_bias(bc2, 0, h, out, D, 0)));
  return 0;
}

// Products this library launched on route 0 (the wgmma core) or 1 (the
// WMMA core), since it was loaded (gemm_sm90.cuh), four a launch; -1 for
// another route.
extern "C" long long lab_wide_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
