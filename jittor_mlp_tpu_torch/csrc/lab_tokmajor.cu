// The kernel lab's token-major Mixer block in bf16 for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces the Pallas TPU kernel tools/kernel_lab.py::_call_tokmajor (body
// `_kernel_tokmajor`). The activation is held token-major, x (G, N, bt, D)
// with G = B / bt, across a whole stack (the caller relays it once before
// and once after). With the same rounding points as that body:
//   xn  = bf16(LN1(x))                          rows of D, in place
//   t   = bf16(gelu_tanh(Wt1 · xn_g + bt1))     xn_g the (N, bt·D) group
//   hf  = (x + Wt2 · t) + bt2                   f32, kept
//   h   = bf16(hf)
//   hn  = bf16(LN2(hf))                         from the f32 h
//   c   = bf16(gelu_tanh(hn · Wc1^T + bc1))     all G·N·bt rows
//   out = bf16(h + (c · Wc2^T + bc2))
// Products accumulate in f32 on the tensor cores, all four through kernel
// 1's code (mixer_forward.cuh's token_products, gemm_tn): on gemm_sm90.cuh's
// wgmma core where TMA can load the operands, else on gemm_bf16.cuh's WMMA
// core.
//
// What bounds it on this card, and what the design does about it:
// - As kernel 1 (mixer_block.cu), the channel GEMMs carry 89% of the FLOPs
//   and are compute-bound; they take all G·N·bt rows as one M.
// - The layout makes each group's (N, bt, D) slab a plain (N, bt·D) matrix,
//   so both token products are one batched GEMM over the G groups with the
//   shared weight as A (batch stride 0; Wt1 copied into rows of
//   round_up(N, 8)) and the group as an N-major B at leading dimension bt·D:
//   no relayout inside the block. TMA needs bt·D % 8 == 0 (and TD % 8 == 0
//   for the second product); else those products take the WMMA core. A
//   192×192 tile does the same work whether it spans one image or several,
//   so the wider product brings no more reuse per tile; it trades kernel
//   1's B-fold batch for a G-fold one.
// - The f32 h that LN2 reads is the body's semantics: an extra f32 store and
//   read of (B, N, D), ≈ 0.05 ms a block at b256 at the HBM rate.
// Keeping the intermediates on chip is later work.

#include "lab_block.cuh"

using namespace jmt;

// All pointers are contiguous device buffers, bf16 but hf (f32). Scratch:
// xn (G, N, bt, D), reused for hn; t (G, TD, bt·D); wt1p (TD, round_up(N,
// 8)), Wt1 in rows a TMA load can stride; h (G, N, bt, D); hf (G, N, bt, D)
// f32; c (G·N·bt, CD). Returns a cudaError_t code (0 on
// success) from the first launch that failed.
extern "C" int lab_tokmajor_bf16(const void* x, const void* ln1w, const void* ln1b,
                                 const void* wt1, const void* bt1, const void* wt2,
                                 const void* bt2, const void* ln2w, const void* ln2b,
                                 const void* wc1, const void* bc1, const void* wc2,
                                 const void* bc2, void* xn, void* t, void* wt1p, void* h,
                                 void* hf, void* c, void* out, int G, int N, int bt, int D,
                                 int TD, int CD, void* stream_ptr) {
  using bf16gemm::gelu_bias;
  using bf16gemm::residual_bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const int W = bt * D, rows = G * N * bt;
  const long long nw = (long long)N * W, tw = (long long)TD * W;
  JMT_CHECK(layer_norm(s, x, D, ln1w, ln1b, xn, rows, D));
  // token mix, an entry a group of bt images: t = gelu(Wt1 · xn_g + bt1); h = x + Wt2 · t + bt2
  if (const int e = token_products(
          s, G, N, W, TD, wt1, wt1p, xn, W, nw, wt2, t, W, tw, gelu_bias(bt1, 1, t, W, tw),
          lab::token_residual(bt2, x, h, static_cast<float*>(hf), W, nw)))
    return e;
  JMT_CHECK(lab::layer_norm_grouped(s, static_cast<const float*>(hf), ln2w, ln2b, xn, rows, D,
                                    rows, 1));
  // channel mix over all rows: c = gelu(hn · Wc1^T + bc1); out = h + c · Wc2^T + bc2
  JMT_CHECK(sm90::gemm_tn<sm90::Sched::Handoff>(s, rows, CD, D, xn, D, wc1, D,
                                                 gelu_bias(bc1, 0, c, CD, 0)));
  JMT_CHECK(sm90::gemm_tn(s, rows, D, CD, c, CD, wc2, CD, residual_bias(bc2, 0, h, out, D, 0)));
  return 0;
}

// Products this library launched on route 0 (the wgmma core) or 1 (the
// WMMA core), since it was loaded (gemm_sm90.cuh), four a launch; -1 for
// another route.
extern "C" long long lab_tokmajor_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
