// The kernel lab's ablated and no-scratch Mixer blocks in bf16 for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel tools/kernel_lab.py::_call with the bodies
// of `_make_kernel_ablate(use_gelu, use_ln)`, which take the block's
// non-product work out one piece at a time, and `_kernel_noscratch`, which
// is the (exact, LN on) body with h kept in the output buffer. For x
// (B, N, D), with the same rounding points and addition order as those
// bodies:
//   xn  = bf16(LN1(x)), or x with LN off
//   t   = bf16(act(Wt1 · xn + bt1))             per image
//   h   = bf16((x + Wt2 · t) + bt2)
//   hn  = bf16(LN2(h)), or h with LN off
//   c   = bf16(act(hn · Wc1^T + bc1))           all B·N rows
//   out = bf16(h + (c · Wc2^T + bc2))
// act is the exact-erf GELU, the 3-term A&S 7.1.25 erf GELU (`fast3`, the
// polynomial the ablation measures, so not replaced by erff), the tanh
// GELU, or ReLU. Products accumulate in f32 on the tensor cores, all four
// through kernel 1's code and on kernel 1's layouts (mixer_forward.cuh's
// token_products an entry an image, xn and t N-major; gemm_tn): on
// gemm_sm90.cuh's wgmma core where TMA can load the operands, else on
// gemm_bf16.cuh's WMMA core.
//
// What bounds it on this card, and what the design does about it: the
// products are kernel 1's (mixer_block.cu) and so is what bounds them; the
// activation is a template parameter of the epilogues, so each mode costs
// only its own arithmetic. With LN off the two LayerNorm launches are
// skipped and the products read x and h themselves (the same operand
// layouts): the timing difference is the LayerNorms' whole cost, launches
// included.
//
// The no-scratch body passes the output buffer as h. The last product's
// epilogue then reads h from `out` and writes the sum back to the same
// element. That is safe on either core: each output element lies in one
// output tile (192×192 on the wgmma core, 128×128 on the WMMA core) and is
// read, then written, by the one epilogue call that covers its row and
// eight columns; no other block touches it, and no product reads h after.

#include "lab_block.cuh"

using namespace jmt;

namespace {

template <lab::Act A>
int run(cudaStream_t s, const void* x, const void* ln1w, const void* ln1b, const void* wt1,
        const void* bt1, const void* wt2, const void* bt2, const void* ln2w, const void* ln2b,
        const void* wc1, const void* bc1, const void* wc2, const void* bc2, void* xn, void* t,
        void* wt1p, void* h, void* c, void* out, int B, int N, int D, int TD, int CD, bool ln) {
  using bf16gemm::residual_bias;
  const long long nd = (long long)N * D, td = (long long)TD * D;
  const void* x_in = x;  // the first product's operand: LN1(x), or x
  if (ln) {
    JMT_CHECK(layer_norm(s, x, D, ln1w, ln1b, xn, B * N, D));
    x_in = xn;
  }
  // token mix, an entry an image: t = act(Wt1 · xn + bt1); h = (x + Wt2 · t) + bt2
  if (const int e = token_products(s, B, N, D, TD, wt1, wt1p, x_in, D, nd, wt2, t, D, td,
                                   lab::act_bias<A>(bt1, 1, t, D, td),
                                   lab::token_residual(bt2, x, h, nullptr, D, nd)))
    return e;
  const void* h_in = h;  // the third product's operand: LN2(h), or h
  if (ln) {
    JMT_CHECK(layer_norm(s, h, D, ln2w, ln2b, xn, B * N, D));
    h_in = xn;
  }
  JMT_CHECK(sm90::gemm_tn(s, B * N, CD, D, h_in, D, wc1, D, lab::act_bias<A>(bc1, 0, c, CD, 0)));
  JMT_CHECK(sm90::gemm_tn(s, B * N, D, CD, c, CD, wc2, CD, residual_bias(bc2, 0, h, out, D, 0)));
  return 0;
}

}  // namespace

// All pointers are contiguous bf16 device buffers. Scratch: xn (B, N, D),
// reused for hn (unused with LN off); t (B, TD, D); wt1p (TD, round_up(N,
// 8)), Wt1 in rows a TMA load can stride; h (B, N, D), which may be `out`;
// c (B·N, CD). act: 0 exact, 1 fast3, 2 tanh, 3 relu; ln: 1 on, 0 off.
// Returns a cudaError_t code (0 on success) from the first launch that
// failed, cudaErrorInvalidValue for an unknown act.
extern "C" int lab_ablate_bf16(const void* x, const void* ln1w, const void* ln1b, const void* wt1,
                               const void* bt1, const void* wt2, const void* bt2,
                               const void* ln2w, const void* ln2b, const void* wc1,
                               const void* bc1, const void* wc2, const void* bc2, void* xn,
                               void* t, void* wt1p, void* h, void* c, void* out, int B, int N,
                               int D, int TD, int CD, int act, int ln, void* stream_ptr) {
  using lab::Act;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define JMT_ARGS s, x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2, xn, t, \
                 wt1p, h, c, out, B, N, D, TD, CD, ln != 0
  switch (act) {
    case 0: return run<Act::Exact>(JMT_ARGS);
    case 1: return run<Act::Fast3>(JMT_ARGS);
    case 2: return run<Act::Tanh>(JMT_ARGS);
    case 3: return run<Act::Relu>(JMT_ARGS);
  }
#undef JMT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Products this library launched on route 0 (the wgmma core) or 1 (the
// WMMA core), since it was loaded (gemm_sm90.cuh), four a launch; -1 for
// another route.
extern "C" long long lab_ablate_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
