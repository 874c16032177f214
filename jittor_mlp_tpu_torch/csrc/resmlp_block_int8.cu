// W8A8 ResMLP block forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/
// resmlp_block_int8.py::fused_resmlp_block_int8 (body `_kernel_int8`), on
// the same int8 GEMM (gemm_s8.cuh) and quantize passes (quant_s8.cuh) as the
// W8A8 Mixer block. For x (B, N, D) bf16, everything stays f32 up to the
// quantizations (nothing is rounded to bf16 before the output):
//   h1  = x · α1 + β1
//   qh, sh = quant of h1 over the tokens, per column d, per image
//   h2  = (h1 + γ1 · ((acc(qWt · qh) · swt) · sh + bt)) · α2 + β2
//   qhb, shb = quant of h2 per row, over D
//   c   = gelu_tanh((acc(qhb · qW1ᵀ) · shb) · sw1 + c1)             (B·N, F)
//   qc, sc = quant per (row, chunk); ck = F/4 when F % 4 = 0 and F ≥ 2048,
//            else F (ResMLP-S24: F = 1536, one chunk)
//   out = bf16(h2 + γ2 · (Σ_chunks (acc(qc · qW2ᵀ) · sc) · sw2 + c2))
//
// What bounds it on this card, and what the design does about it:
// - 2·B·N·(N·D + 2·D·F) integer operations: 125.9 G at b256 for
//   ResMLP-S24, 0.064 ms at the data sheet's 1,979 dense int8 TOPS.
// - As in the W8A8 Mixer block, each activation scale is a reduction over
//   the K axis of the product that consumes the codes: the quantizations
//   are passes of their own, and h2 (B, N, D) and c (B·N, F) go through
//   device memory in f32. Six launches per block.
// - The token product is N × N per image with K = N = 196, padded with zero
//   codes to 224; its B operand is written transposed, (B, D, Np).

#include "gemm_s8.cuh"
#include "quant_s8.cuh"

using namespace jmt;

namespace {

// Token-mix epilogue: h2 = (h1 + γ1·(v + bt)) · α2 + β2 with h1 = x·α1 + β1,
// stored f32 at (z, m, n) of (B, N, D).
struct TokenAffine {
  quant::AffSrc h1;
  const bf16* bt;
  const bf16* g1;
  const bf16* a2;
  const bf16* b2;
  float* h2;
  int D;
  long long sz;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const float b = __bfloat162float(bt[m]);
    for (int e = 0; e < cnt; ++e) {
      const int c = n + e;
      const float t = __fadd_rn(v[e], b);
      const float hh = __fadd_rn(h1(z, m, c), __fmul_rn(__bfloat162float(g1[c]), t));
      h2[z * sz + (long long)m * D + c] =
          __fadd_rn(__fmul_rn(hh, __bfloat162float(a2[c])), __bfloat162float(b2[c]));
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

struct Dims {
  int B, N, D, F, Np, Dp, ck, ckp, nch, M;

  Dims(int B_, int N_, int D_, int F_) : B(B_), N(N_), D(D_), F(F_) {
    Np = round_up(N, 32);
    Dp = round_up(D, 32);
    ck = (F % 4 == 0 && F >= 2048) ? F / 4 : F;
    ckp = round_up(ck, 32);
    nch = F / ck;
    M = B * N;
  }
};

struct Work {
  int8_t* qh;
  float* sh;
  float* h2;
  int8_t* qhb;
  float* shb;
  float* c;
  int8_t* qc;
  float* sc;

  Work(Carver& w, const Dims& d) {
    const size_t bd = (size_t)d.B * d.D;
    qh = w.take<int8_t>(bd * d.Np);
    sh = w.take<float>(bd);
    h2 = w.take<float>((size_t)d.M * d.D);
    qhb = w.take<int8_t>((size_t)d.M * d.Dp);
    shb = w.take<float>(d.M);
    c = w.take<float>((size_t)d.M * d.F);
    qc = w.take<int8_t>((size_t)d.M * d.nch * d.ckp);
    sc = w.take<float>((size_t)d.M * d.nch);
  }
};

}  // namespace

// Bytes of device workspace resmlp_block_int8 needs.
extern "C" size_t resmlp_block_int8_workspace(int B, int N, int D, int F) {
  Carver counter{nullptr};
  const Work work(counter, Dims(B, N, D, F));
  (void)work;
  return counter.bytes;
}

// x, a*, b*, g*, bt, c1, c2, out: bf16 (affines flattened to (D,)). qwt
// (N, Np), qw1 (F, Dp), qw2 (D, nch·ckp): int8 weights quantized per output
// channel (row), zero in the padding; swt (N), sw1 (F), sw2 (D): their f32
// scales. ws: resmlp_block_int8_workspace bytes. Returns a cudaError_t code
// (0 on success) from the first launch that failed.
extern "C" int resmlp_block_int8(const void* x, const void* a1, const void* b1, const void* g1,
                                 const void* qwt, const void* swt, const void* bt,
                                 const void* a2, const void* b2, const void* g2,
                                 const void* qw1, const void* sw1, const void* c1,
                                 const void* qw2, const void* sw2, const void* c2, void* ws,
                                 void* out, int B, int N, int D, int F, void* stream_ptr) {
  using s8gemm::gemm;
  using s8gemm::Scales;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const Dims d(B, N, D, F);
  Carver carver{static_cast<char*>(ws)};
  const Work w(carver, d);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const quant::AffSrc h1{bf(x), bf(a1), bf(b1), N, D};

  // token mix, per image
  JMT_CHECK(quant::quant_cols(s, h1, B, N, d.Np, D, w.qh, w.sh));
  JMT_CHECK(gemm(s, B, N, D, d.Np, d.Np, qwt, d.Np, 0, w.qh, d.Np, (long long)D * d.Np,
                 Scales{f32(swt), 0, 1, w.sh, D},
                 TokenAffine{h1, bf(bt), bf(g1), bf(a2), bf(b2), w.h2, D, (long long)N * D}));
  // channel FF over all B·N rows, the hidden axis in chunks
  JMT_CHECK(quant::quant_rows(s, quant::F32Src{w.h2, 0, D}, d.M, 1, D, d.Dp, w.qhb, w.shb));
  JMT_CHECK(gemm(s, 1, d.M, F, d.Dp, d.Dp, w.qhb, d.Dp, 0, qw1, d.Dp, 0,
                 Scales{w.shb, 0, 1, f32(sw1), 0},
                 s8gemm::BiasGeluF32{bf(c1), 0, w.c, F, 0}));
  JMT_CHECK(quant::quant_rows(s, quant::F32Src{w.c, 0, F}, d.M, d.nch, d.ck, d.ckp, w.qc,
                              w.sc));
  const int K2 = d.nch * d.ckp;
  JMT_CHECK(gemm(s, 1, d.M, D, K2, d.ckp, w.qc, K2, 0, qw2, K2, 0,
                 Scales{w.sc, 0, d.nch, f32(sw2), 0},
                 ScaledResid{w.h2, bf(g2), bf(c2), static_cast<bf16*>(out), D}));
  return 0;
}

extern "C" const char* resmlp_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
