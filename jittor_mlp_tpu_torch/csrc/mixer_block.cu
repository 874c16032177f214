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
// All products accumulate in f32 on the tensor cores, on the Hopper core
// (gemm_sm90.cuh) where TMA can load their operands, else on the WMMA core
// (gemm_bf16.cuh).
//
// What bounds it on this card, and what the design does about it:
// - The TPU kernel keeps all four weight matrices in VMEM. Here Wc1 alone is
//   4.7 MB in bf16, far beyond a block's 227 KB of shared memory, so the
//   block runs as launches on the caller's stream: LN, a copy of Wt1, GEMM,
//   GEMM, LN, GEMM, GEMM. Intermediates (xn/hn, t, h, c) go through device
//   memory; the weights are shared by every image (batch stride 0) and stay
//   in the 50 MB L2 cache.
// - The channel GEMMs carry CD/(CD+TD) = 3072/3456 ≈ 89% of the FLOPs. They
//   stack all B·N rows into one M, so at serving batch sizes they are large,
//   compute-bound products on gemm_sm90.cuh's wgmma core: TMA loads into an
//   mbarrier ring feeding wgmma.m64n192k16, persistent blocks. The GELU
//   product runs its handoff schedule: one MMA warpgroup's K loops back to
//   back on 128×192 tiles, each tile's f32 sums through shared memory to
//   eleven epilogue warps that run the tanh GELU under the next tile's
//   wgmmas (at Mixer-B/16 b256 0.4637 ms against 0.5716 on the cooperative
//   schedule, whose epilogue follows the K loops; its K loop alone ≈ 0.33).
//   The residual product keeps the cooperative schedule (192×192 tiles of
//   three consumer warpgroups: 0.3529 ms against the handoff one's 0.3739;
//   its epilogue is short beside its K of CD), the split entry's f32 partial
//   the handoff one (0.2018 against 0.2319 ms at P = 2). H100 80GB HBM3 at
//   700 W, chip_smoke.py phases 5 and 14a. Where TMA cannot load an operand
//   (a row stride that is not a multiple of 16 bytes, e.g. D % 8 ≠ 0) they
//   take the WMMA core on the same arguments.
// - The token GEMMs (K = N = 196 and K = TD = 384) are small per image and
//   bound by bytes at this design: each reads and writes a whole (B, TD, D)
//   intermediate (at Mixer-B/16 b256 59.2 GFLOP, 0.060 ms at the dense
//   bf16 peak, against ≈ 0.53 GB, 0.159 ms at the HBM rate). They run on
//   the same core, an entry an image through its batch axis (a 3-D tensor
//   map for every image but the last), the weight the shared A operand and
//   the activations N-major B operands (K × D row-major per image, read
//   with wgmma's transpose bit: the core's TB mode).
// - Rows of Wt1 (384, 196) are 392 bytes apart, not a multiple of 16, which
//   TMA cannot stride: each call first copies Wt1 into rows of
//   Np = round_up(N, 8) (400 bytes), zero past column N, a (TD, Np) scratch
//   the caller gives. Wt2 (196, 384) is loaded as it is (768-byte rows).
// - N = 196 is not a multiple of any tile size. It is the K of the first
//   token GEMM, whose ragged K tail TMA zero-fills, and the M of the
//   second, cut as 192 + 4 rows (two row tiles; the epilogue stores rows
//   < N), instead of the TPU version's padding to 128.
// - Where TMA's rules fail for a token product (D % 8 ≠ 0 for xn and t,
//   TD % 8 ≠ 0 for Wt2) it takes the WMMA core on the same arguments. Each
//   product is counted on the route it took (mixer_gemm_products).
// Keeping t on chip (the TPU kernel's VMEM form) and the token products'
// epilogues beside their wgmmas are later work.
//
// Tensor parallelism (parallel/tensor.py): the JAX package shards Wc1 and
// bc1 on the channel hidden axis and Wc2 on its input axis over the mesh's
// 'model' axis, so rank r of P holds CD_r = CD / P hidden columns. The
// split entry mixer_block_bf16_tp runs the block up to c as above at
// CD_r and stores the f32 partial p_r = c_r · Wc2_r^T of the last product
// through the core's f32 store epilogue (no bias, no residual; the handoff
// schedule, as the whole block's second channel product). The caller
// sums the ranks' partials (an all-reduce) and the finishing pass
// mixer_block_tp_finish writes out = bf16(h + (Σ p_r + bc2)): the rounding
// points of the whole block, with the f32 sum of the second channel product
// taken in another order. Wc2_r is (D, CD_r), contiguous: TMA loads it
// where CD_r % 8 == 0, else the product takes the WMMA core. The pass reads
// h and s and writes out once (8 bytes an element, bound by bytes).

#include "mixer_forward.cuh"

using namespace jmt;

// All pointers are contiguous bf16 device buffers. Scratch: xn (B, N, D),
// reused for hn; t (B, TD, D); wt1p (TD, round_up(N, 8)); h (B, N, D);
// c (B·N, CD). Returns a cudaError_t code (0 on success) from the first
// call that failed.
extern "C" int mixer_block_bf16(const void* x, const void* ln1w, const void* ln1b,
                                const void* wt1, const void* bt1, const void* wt2,
                                const void* bt2, const void* ln2w, const void* ln2b,
                                const void* wc1, const void* bc1, const void* wc2,
                                const void* bc2, void* xn, void* t, void* wt1p, void* h,
                                void* c, void* out, int B, int N, int D, int TD, int CD,
                                void* stream_ptr) {
  return mixer_forward(static_cast<cudaStream_t>(stream_ptr), x, ln1w, ln1b, wt1, bt1, wt2, bt2,
                       ln2w, ln2b, wc1, bc1, wc2, bc2, xn, t, wt1p, h, c, out, B, N, D, TD, CD);
}

// The split entry: the block up to c at CD = CD_r (this rank's hidden
// columns; wc1 (CD_r, D), bc1 (CD_r,), wc2 (D, CD_r)), then the f32 partial
// (B·N, D) = c · Wc2^T with no bias and no residual. h (B, N, D) is left
// for the finishing pass. Scratch as above.
extern "C" int mixer_block_bf16_tp(const void* x, const void* ln1w, const void* ln1b,
                                   const void* wt1, const void* bt1, const void* wt2,
                                   const void* bt2, const void* ln2w, const void* ln2b,
                                   const void* wc1, const void* bc1, const void* wc2, void* xn,
                                   void* t, void* wt1p, void* h, void* c, void* partial, int B,
                                   int N, int D, int TD, int CD, void* stream_ptr) {
  const auto s = static_cast<cudaStream_t>(stream_ptr);
  const int e = mixer_forward_hidden(s, x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1,
                                     xn, t, wt1p, h, c, B, N, D, TD, CD);
  if (e) return e;
  JMT_CHECK(sm90::gemm_tn<sm90::Sched::Handoff>(
      s, B * N, D, CD, c, CD, wc2, CD, sm90::StoreEntries{static_cast<float*>(partial), B * N, D}));
  return 0;
}

// out = bf16(h + (s + bias)), eight elements a thread (ResidualBias's
// arithmetic in its order); rows of D % 8 == 0, 16-byte aligned buffers.
__global__ void tp_finish8(const bf16* __restrict__ h, const float* __restrict__ s,
                           const bf16* __restrict__ bias, bf16* __restrict__ out, long long n8,
                           int D) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += step) {
    const long long e0 = i * 8;
    const uint4 hv = *reinterpret_cast<const uint4*>(h + e0);
    const uint4 bv = col8(bias, (int)(e0 % D));
    float sv[8], v[8];
    load8(s + e0, sv);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = at8(hv, e) + (sv[e] + at8(bv, e));
    store8(out + e0, v);
  }
}

// The same, one element a thread, for any D and alignment.
__global__ void tp_finish1(const bf16* __restrict__ h, const float* __restrict__ s,
                           const bf16* __restrict__ bias, bf16* __restrict__ out, long long n,
                           int D) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    out[i] = __float2bfloat16(__bfloat162float(h[i]) + (s[i] + __bfloat162float(bias[i % D])));
}

// The finishing pass of the split block: h, out (rows, D) bf16, s (rows, D)
// f32 (the sum of the ranks' partials), bias (D,) bf16.
extern "C" int mixer_block_tp_finish(const void* h, const void* s, const void* bias, void* out,
                                     int rows, int D, void* stream_ptr) {
  const auto st = static_cast<cudaStream_t>(stream_ptr);
  const long long n = (long long)rows * D;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  JMT_CHECK(cudaGetDevice(&dev));
  JMT_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int threads = 256;
  const bool vec = vec_ok(h, D, 0) && vec_ok(s, D, 0, 4) && vec_ok(out, D, 0);
  const long long work = vec ? n / 8 : n;
  const long long want = (work + threads - 1) / threads;
  const int grid = (int)(want < 16LL * sms ? want : 16LL * sms);
  if (vec) {
    tp_finish8<<<grid, threads, 0, st>>>(static_cast<const bf16*>(h), static_cast<const float*>(s),
                                         static_cast<const bf16*>(bias), static_cast<bf16*>(out),
                                         work, D);
  } else {
    tp_finish1<<<grid, threads, 0, st>>>(static_cast<const bf16*>(h), static_cast<const float*>(s),
                                         static_cast<const bf16*>(bias), static_cast<bf16*>(out),
                                         work, D);
  }
  return (int)cudaGetLastError();
}

// Products this library launched on route 0 (the wgmma core) or 1 (the
// WMMA core), since it was loaded (gemm_sm90.cuh): four a block (the two
// token products, the two channel products); -1 for another route.
extern "C" long long mixer_gemm_products(int route) { return sm90::products(route); }

// The wgmma core's launches by this library so far in mode `mode` (0 plain:
// the token products and the residual channel product; 4 handoff: the GELU
// channel product and the split entry's f32 partial); -1 for another
// mode.
extern "C" long long mixer_mode_launches(int mode) { return sm90::mode_launches(mode); }

extern "C" const char* mixer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
