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
// All products accumulate in f32 on the tensor cores: the channel products
// on the Hopper core (gemm_sm90.cuh), the token products on the WMMA core
// (gemm_bf16.cuh).
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
//   compute-bound products. They run on gemm_sm90.cuh: TMA loads into a
//   four-stage mbarrier ring feeding wgmma.m64n192k16 from warp-specialized
//   warpgroups, 192×192 output tiles, persistent blocks. Where TMA cannot
//   load an operand (a row stride that is not a multiple of 16 bytes, e.g.
//   D % 8 ≠ 0) they take the WMMA core on the same arguments.
// - The token GEMMs (K = N = 196 and K = TD = 384) are small per image and
//   bandwidth-bound at this design: each reads and writes a whole (B, TD, D)
//   intermediate. They run batched over images (grid z) with the weight as
//   the shared A operand.
// - N = 196 is not a multiple of any tile size. It is the K of the first
//   token GEMM and the M of the second: ragged K tails are zero-filled in
//   shared memory and ragged M/N edges are masked in the epilogue, instead
//   of the TPU version's padding to 128.
// - Rows of Wt1 (384, 196) are 392 bytes apart, not 16-byte aligned, which
//   TMA cannot load. The token products stay on the WMMA core (128×128
//   tiles, a two-stage cp.async ring), whose tile loader uses 16-byte
//   cp.async copies only where the base, leading dimension and batch stride
//   allow it, and 2-byte loads elsewhere.
// The token products on wgmma and keeping the intermediates on chip are
// later work.

#include "mixer_forward.cuh"

using namespace jmt;

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
  return mixer_forward(static_cast<cudaStream_t>(stream_ptr), x, ln1w, ln1b, wt1, bt1, wt2, bt2,
                       ln2w, ln2b, wc1, bc1, wc2, bc2, xn, t, h, c, out, B, N, D, TD, CD);
}

// Channel products this library launched on route 0 (the wgmma core) or
// 1 (the WMMA core), since it was loaded (gemm_sm90.cuh); -1 for another
// route.
extern "C" long long mixer_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* mixer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
