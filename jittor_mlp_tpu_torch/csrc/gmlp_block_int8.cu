// W8A8 gMLP block forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/
// gmlp_block_int8.py::fused_gmlp_block_int8 (body `_kernel_int8`), on the
// same int8 GEMM (gemm_s8.cuh) and quantize passes (quant_s8.cuh) as the
// W8A8 Mixer and ResMLP blocks. Weights arrive quantized per output channel
// (the wrapper quantizes them, as the JAX wrapper does outside its kernel).
// For x (B, N, D) bf16, everything stays f32 up to the output:
//   xn  = LN1(x)
//   qxn, sxn = quant of xn per row, over D
//   y   = gelu_tanh((acc(qxn · qW1ᵀ) · sxn) · sw1 + b1)         (B·N, 2F)
//   u, v = y[:, :F], y[:, F:];  vn = LN2(v)
//   qv, sv = quant of vn per image, per column f, over the N tokens
//   g   = u · ((acc(qWsp · qv) · swsp) · sv + bs)                per image
//   qg, sg = quant of g per row, over the whole F (no chunks)
//   out = bf16(x + ((acc(qg · qW2ᵀ) · sg) · sw2 + b2))
//
// What bounds it on this card, and what the design does about it:
// - 2·B·N·(D·2F + N·F + F·D) integer operations: 148.6 G at b256 for
//   gMLP-S (N = 196, D = 256, F = 1536), 0.075 ms at the data sheet's
//   1,979 dense int8 TOPS.
// - Each activation scale is a reduction over the K axis of the product
//   that consumes the codes, so every quantization is a pass of its own
//   between the GEMMs, and the f32 intermediates y (B·N, 2F) and g (B·N, F)
//   go through device memory unrounded, as the reference keeps them: y is
//   616 MB and g 308 MB at b256. That traffic is this design's cost; eight
//   launches per block.
// - The SGU's norm runs on the strided f32 v half of y: its statistics by
//   row_stats_f32, the normalized values recomputed by the token quantize
//   pass (LnF32Src), so vn is never stored.
// - mma.sync's s8 shapes take both operands K-contiguous: the token
//   product's B operand is written transposed, (B, F, Np), by the quantize
//   pass, with the tokens padded with zero codes to Np = round_up(N, 32)
//   (exact; the padding does not change a column's absmax).
// - The gate is the token product's epilogue: it adds bs per token and
//   multiplies by u, read at leading dimension 2F; v2 never reaches device
//   memory.

#include "gemm_s8.cuh"
#include "quant_s8.cuh"

using namespace jmt;

namespace {

// Token-product epilogue at (z, m, n) of (B, N, F):
//   g[z·N + m, n] = u · (v + bs[m]),  u = y[z·N + m, n] at leading dimension ldu.
struct GateF32 {
  const float* y;
  int ldu;
  const bf16* bs;
  float* g;
  int F, N;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const long long row = z * N + m;
    const float b = __bfloat162float(bs[m]);
    for (int e = 0; e < cnt; ++e)
      g[row * F + n + e] = __fmul_rn(y[row * ldu + n + e], __fadd_rn(v[e], b));
  }
};

struct Dims {
  int B, N, D, F, Np, Dp, Fp, M;

  Dims(int B_, int N_, int D_, int F_) : B(B_), N(N_), D(D_), F(F_) {
    Np = round_up(N, 32);
    Dp = round_up(D, 32);
    Fp = round_up(F, 32);
    M = B * N;
  }
};

struct Work {
  float2* stats;  // LN1's, then LN2's
  int8_t* qxn;
  float* sxn;
  float* y;
  int8_t* qv;
  float* sv;
  float* g;
  int8_t* qg;
  float* sg;

  Work(Carver& w, const Dims& d) {
    const size_t bf = (size_t)d.B * d.F;
    stats = w.take<float2>(d.M);
    qxn = w.take<int8_t>((size_t)d.M * d.Dp);
    sxn = w.take<float>(d.M);
    y = w.take<float>((size_t)d.M * 2 * d.F);
    qv = w.take<int8_t>(bf * d.Np);
    sv = w.take<float>(bf);
    g = w.take<float>((size_t)d.M * d.F);
    qg = w.take<int8_t>((size_t)d.M * d.Fp);
    sg = w.take<float>(d.M);
  }
};

}  // namespace

// Bytes of device workspace gmlp_block_int8 needs.
extern "C" size_t gmlp_block_int8_workspace(int B, int N, int D, int F) {
  Carver counter{nullptr};
  const Work work(counter, Dims(B, N, D, F));
  (void)work;
  return counter.bytes;
}

// x, ln1w, ln1b, b1, sgu_w, sgu_b, bs, b2, out: bf16. qw1 (2F, Dp),
// qwsp (N, Np), qw2 (D, Fp): int8 weights quantized per output channel
// (row), zero in the padding; sw1 (2F), swsp (N), sw2 (D): their f32
// scales. ws: gmlp_block_int8_workspace bytes. Returns a cudaError_t code
// (0 on success) from the first launch that failed.
extern "C" int gmlp_block_int8(const void* x, const void* ln1w, const void* ln1b,
                               const void* qw1, const void* sw1, const void* b1,
                               const void* sgu_w, const void* sgu_b, const void* qwsp,
                               const void* swsp, const void* bs, const void* qw2,
                               const void* sw2, const void* b2, void* ws, void* out, int B,
                               int N, int D, int F, void* stream_ptr) {
  using s8gemm::gemm;
  using s8gemm::Scales;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const Dims d(B, N, D, F);
  Carver carver{static_cast<char*>(ws)};
  const Work w(carver, d);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const int F2 = 2 * F;

  // channel expand over all B·N rows
  JMT_CHECK(quant::row_stats(s, x, w.stats, d.M, D));
  JMT_CHECK(quant::quant_rows(s, quant::LnSrc{bf(x), w.stats, bf(ln1w), bf(ln1b), d.M, D}, d.M,
                              1, D, d.Dp, w.qxn, w.sxn));
  JMT_CHECK(gemm(s, 1, d.M, F2, d.Dp, d.Dp, w.qxn, d.Dp, 0, qw1, d.Dp, 0,
                 Scales{w.sxn, 0, 1, f32(sw1), 0}, s8gemm::BiasGeluF32{bf(b1), 0, w.y, F2, 0}));
  // the SGU: LN2 of the v half, quantized per image over the tokens; the
  // token product per image, gated by u in its epilogue
  JMT_CHECK(quant::row_stats_f32(s, w.y + F, F2, w.stats, d.M, F));
  JMT_CHECK(quant::quant_cols(s, quant::LnF32Src{w.y + F, F2, w.stats, bf(sgu_w), bf(sgu_b), N},
                              B, N, d.Np, F, w.qv, w.sv));
  JMT_CHECK(gemm(s, B, N, F, d.Np, d.Np, qwsp, d.Np, 0, w.qv, d.Np, (long long)F * d.Np,
                 Scales{f32(swsp), 0, 1, w.sv, F}, GateF32{w.y, F2, bf(bs), w.g, F, N}));
  // channel project back with the residual
  JMT_CHECK(quant::quant_rows(s, quant::F32Src{w.g, 0, F}, d.M, 1, F, d.Fp, w.qg, w.sg));
  JMT_CHECK(gemm(s, 1, d.M, D, d.Fp, d.Fp, w.qg, d.Fp, 0, qw2, d.Fp, 0,
                 Scales{w.sg, 0, 1, f32(sw2), 0},
                 s8gemm::ResidBias{bf(x), bf(b2), 0, 1, static_cast<bf16*>(out), D, 0}));
  return 0;
}

extern "C" const char* gmlp_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
