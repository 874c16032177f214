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
// cores, on gemm_sm90.cuh's bf16 wgmma core with ResMLP epilogues.
//
// What bounds it on this card, and what the design does about it:
// - 2·B·N·(N·D + 2·D·F) flops: 125.9 G at b256 for ResMLP-S24 (N = 196,
//   D = 384, F = 1536), 0.127 ms at the data sheet's 989 dense bf16 TFLOP/s.
//   The two FF products carry 94% of them and stack all B·N rows into one M.
// - No VMEM: the block is four launches (affine, token product, FF1, FF2)
//   after a copy of Wt; h, h2 (f32 and bf16) and c go through device
//   memory; the weights are shared by every image and stay in the 50 MB L2
//   cache. The bytes floor of this data flow at b256 for ResMLP-S24: x read
//   (38.5 MB), h written and read twice (the token product's B operand, its
//   epilogue), h2 in f32 written and read (the last residual; 77 MB each
//   way), h2b written and read (FF1), c written and read (154 MB each way),
//   out written: 0.735 GB, 0.219 ms at 3.35 TB/s, 1.7× the operation bound.
// - The three products run on the wgmma core (TMA loads, wgmma from
//   warp-specialized warpgroups, persistent blocks), where the WMMA core
//   (gemm_bf16.cuh) ran them before. FF1 (K = D = 384, six K steps) is bound
//   by its epilogue, the tanh GELU and the bf16 stores of B·N·F values: it
//   runs on the core's handoff schedule (each 128×192 tile's sums handed to
//   eleven epilogue warps under the next tile's wgmmas), the GELU
//   common.cuh's x·σ(2u) on the special-function unit. FF2, whose epilogue
//   is short, keeps the cooperative schedule (0.114 ms against 0.122 on the
//   handoff one at b256); its N = D = 384 is two whole 192-wide tiles.
// - The token product is per image through the core's batch axis, M = K =
//   N = 196, with Wt as the shared A operand and h as an N-major B (K × D
//   row-major per image, wgmma's transpose bit: the TB mode, a 3-D tensor
//   map for every image but the last). Wt's 392-byte rows break TMA's
//   16-byte stride rule, so each call first copies Wt into rows of Np =
//   round_up(N, 8) elements (400 bytes), zero in the padding; K stays N, and
//   TMA zero-fills the K tail. It runs on the handoff schedule's batched
//   mode: 128-row tiles cut the 196 tokens as 128 + 68 (the cooperative
//   tile cut them 192 + 4), an image's two row tiles of each column slab
//   back to back, and the affine epilogue under the next tile's wgmmas.
// - Where TMA's rules fail (D not a multiple of 8 for the token product and
//   FF1, F for FF2: rows that are not 16-byte multiples apart) a product
//   takes the WMMA core on the same arguments, a route counted by
//   resmlp_gemm_products as the wgmma one is.
// - The epilogues take eight columns (cnt 8) with 16-byte accesses of h,
//   h2, h2b and out and every load issued before any is used, the same
//   arithmetic as their element loop. With a load, compute and store per
//   element the token product took 0.42 ms a block; the affine pass is
//   eight columns a thread too.
// - Where the time goes (H100 80GB HBM3, 700 W, b256, profile_blocks): a
//   block takes about 0.44 ms (0.56 before its FF1 and token product took
//   the handoff schedule and the SFU GELU; 1.45 with its products on WMMA):
//   FF1 with GELU 0.16, FF2 with the residual 0.13, the token product with
//   its affine epilogue 0.11, the affine 0.025. FF1 and the token product
//   are bound by their epilogues (their MMA warpgroup waits for the
//   epilogue warps 31% and 61% of its time, tools/handoff_variants.py).
// - No atomics: two calls on the same inputs agree bit for bit.

#include <algorithm>

#include "gemm_sm90.cuh"

using namespace jmt;

namespace {

// h = bf16(x · α1 + β1), α1 / β1 per column of (rows, D): eight columns a
// thread as 16-byte accesses where vec (D % 8 == 0, x and y aligned), else
// one.
__global__ void affine_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                              const bf16* __restrict__ b, bf16* __restrict__ y, long long n,
                              int D, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec) {
    for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 8; i < n;
         i += stride * 8) {
      const int c = static_cast<int>(i % D);
      const uint4 xr = *reinterpret_cast<const uint4*>(x + i), av = col8(a, c), bv = col8(b, c);
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __fadd_rn(__fmul_rn(at8(xr, e), at8(av, e)), at8(bv, e));
      store8(y + i, out);
    }
    return;
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = static_cast<int>(i % D);
    y[i] = __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(x[i]), __bfloat162float(a[c])),
                                      __bfloat162float(b[c])));
  }
}

// Token-mix epilogue at (z, m, n) of (B, N, D):
//   h2 = (h + γ1 · (v + bt[m])) · α2 + β2, stored in f32 and as bf16.
// Eight columns (cnt 8) as 16-byte loads of h and stores of h2 and h2b
// where they are aligned, the same arithmetic.
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
    if (cnt == 8 && aligned16(h + o) && aligned16(h2 + o) && aligned16(h2b + o)) {
      const uint4 hr = *reinterpret_cast<const uint4*>(h + o);
      const uint4 g1v = col8(g1, n), a2v = col8(a2, n), b2v = col8(b2, n);
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float hh = __fadd_rn(at8(hr, e), __fmul_rn(at8(g1v, e), __fadd_rn(v[e], b)));
        y[e] = __fadd_rn(__fmul_rn(hh, at8(a2v, e)), at8(b2v, e));
      }
      store8(h2 + o, y);
      store8(h2b + o, y);
      return;
    }
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

// Output epilogue: out = bf16(h2 + γ2 · (v + c2)), (B·N, D). Eight columns
// (cnt 8) as 16-byte loads of h2 and a 16-byte store where they are
// aligned, the same arithmetic.
struct ScaledResid {
  const float* h2;
  const bf16* g2;
  const bf16* c2;
  bf16* out;
  int D;

  __device__ void operator()(long long, int m, int n, const float* v, int cnt) const {
    const long long o0 = (long long)m * D + n;
    if (cnt == 8 && aligned16(h2 + o0) && aligned16(out + o0)) {
      float r[8], y[8];
      load8(h2 + o0, r);
      const uint4 g2v = col8(g2, n), c2v = col8(c2, n);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __fadd_rn(r[e], __fmul_rn(at8(g2v, e), __fadd_rn(v[e], at8(c2v, e))));
      store8(out + o0, y);
      return;
    }
    for (int e = 0; e < cnt; ++e) {
      const long long o = o0 + e;
      const float f = __fadd_rn(v[e], __bfloat162float(c2[n + e]));
      out[o] = __float2bfloat16(__fadd_rn(h2[o], __fmul_rn(__bfloat162float(g2[n + e]), f)));
    }
  }
};

struct Work {
  bf16* wt;  // Wt in rows of Np
  bf16* h;
  float* h2;
  bf16* h2b;
  bf16* c;

  Work(Carver& w, int B, int N, int D, int F) {
    const size_t md = (size_t)B * N * D;
    wt = w.take<bf16>((size_t)N * round_up(N, 8));
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
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  Carver carver{static_cast<char*>(ws)};
  const Work w(carver, B, N, D, F);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  const long long nd = (long long)N * D, md = (long long)B * nd;
  const int M = B * N, Np = round_up(N, 8);

  // Wt → rows of Np, zero past column N
  JMT_CHECK(cudaMemsetAsync(w.wt, 0, sizeof(bf16) * N * Np, s));
  JMT_CHECK(cudaMemcpy2DAsync(w.wt, sizeof(bf16) * Np, wt, sizeof(bf16) * N, sizeof(bf16) * N,
                              N, cudaMemcpyDeviceToDevice, s));
  const bool vec = vec_ok(x, D, 0) && vec_ok(w.h, D, 0);  // D % 8 == 0, 16-byte bases
  const long long items = vec ? md / 8 : md;
  affine_kernel<<<static_cast<unsigned>(std::min<long long>((items + 255) / 256, 8192)), 256, 0,
                  s>>>(bf(x), bf(a1), bf(b1), w.h, md, D, vec);
  JMT_CHECK(cudaGetLastError());
  // token mix per image: Wt shared, h (K = N tokens × D per image) N-major;
  // the affine epilogue under the next tile's wgmmas, an image's two row
  // tiles of each column slab back to back
  JMT_CHECK((sm90::gemm_bf16<false, true, sm90::Sched::Handoff>(
      s, B, N, D, N, N, w.wt, Np, 0, w.h, D, nd,
      TokenAffine{w.h, bf(bt), bf(g1), bf(a2), bf(b2), w.h2, w.h2b, D, nd})));
  // channel FF over all B·N rows, the GELU under the next tile's wgmmas
  JMT_CHECK(sm90::gemm_tn<sm90::Sched::Handoff>(s, M, F, D, w.h2b, D, w1, D,
                                                 gelu_bias(c1, 0, w.c, F, 0)));
  JMT_CHECK(sm90::gemm_tn(s, M, D, F, w.c, F, w2, F,
                          ScaledResid{w.h2, bf(g2), bf(c2), static_cast<bf16*>(out), D}));
  return 0;
}

// Products this library launched on route 0 (the bf16 wgmma core) or 1
// (the WMMA core), since it was loaded (gemm_sm90.cuh); -1 for another
// route.
extern "C" long long resmlp_gemm_products(int route) { return sm90::products(route); }

// The wgmma core's launches by this library so far in mode `mode` (0 plain:
// FF2; 4 handoff: the token product and FF1); -1 for another mode.
extern "C" long long resmlp_mode_launches(int mode) { return sm90::mode_launches(mode); }

extern "C" const char* resmlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
