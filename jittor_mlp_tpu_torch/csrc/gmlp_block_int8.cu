// W8A8 gMLP block forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/
// gmlp_block_int8.py::fused_gmlp_block_int8 (body `_kernel_int8`), with the
// quantize passes (quant_s8.cuh) of the W8A8 Mixer and ResMLP blocks and
// its products on the s8 wgmma core (gemm_sm90.cuh). Weights arrive
// quantized per output channel (the wrapper quantizes them, as the JAX
// wrapper does outside its kernel).
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
//   1,979 dense int8 TOPS: the operation bound.
// - Each activation scale is a reduction over the K axis of the product
//   that consumes the codes, so every quantization is a pass of its own
//   between the products, and the f32 intermediates go through device
//   memory unrounded, as the reference keeps them: y (B·N, 2F) is written
//   once (617 MB at b256), its v half read by LN2's statistics and by the
//   token quantize pass (617 MB), its u half by the gate (308 MB); g
//   (B·N, F) is written once and read by its quantize pass (617 MB). That
//   is 2.16 GB, 0.644 ms at 3.35 TB/s: the floor of this data flow, 8.6×
//   the operation bound, before the int8 codes (0.36 GB written and read).
//   Eight launches per block.
// - The three products run on gemm_sm90.cuh's s8 wgmma core
//   (wgmma.m64n192k32.s32.s8.s8, TMA loads of 128-code rows, persistent
//   blocks): one 128-byte K step is the bf16 core's byte geometry, and the
//   products reach a tensor-core rate the mma.sync core (gemm_s8.cuh,
//   ≈ 70 TOP/s here) did not. The core dequantizes each tile in its
//   epilogue, v = (f32(acc) · rs[m]) · cs[n], and hands v to the W8A8
//   functors below and in gemm_s8.cuh, so every rounding point is where
//   the reference has it. Its epilogue writes eight f32 columns a lane at a
//   time, as two 16-byte stores.
// - wgmma's s8 shapes take both operands K-major: the quantize passes write
//   every operand K-contiguous and zero-padded to 32 codes (Dp 256, Fp 1536,
//   Np 224 bytes a row: TMA's 16-byte stride rule holds); the token
//   product's B operand is written transposed, (B, F, Np), by the token
//   quantize pass, with the tokens padded with zero codes (exact; the
//   padding does not change a column's absmax).
// - The token product runs per image, batched through the tensor map (a
//   3-D map of qv, one entry an image; qWsp shared): M = N = 196 tokens
//   cut as 192 + 4 rows, so the second row tile's wgmmas are mostly zero
//   fill. The alternative, the transposed form (A = qv as (B·F, Np), B =
//   qWsp, one product with an n208 tile over the 196 tokens), was weighed
//   by measuring what the ragged tile costs: on an H100 80GB HBM3 at 700 W
//   the product alone (f32 output, chip_smoke.py phase 5) takes 0.231–0.249
//   ms at b256 for 196 tokens and 0.212 ms for the first 192 alone, against
//   a bytes bound of 0.119 ms. So the transposed form could save at most
//   ≈ 0.03 ms a block (≈ 1.5%), and its epilogue would write g one column
//   a lane (a lane's eight values in eight rows of g) instead of 32
//   contiguous bytes: the per-image form stays. The product is bound by its epilogue's bytes (u read, g
//   written), not by its 30 G operations.
// - Where the time goes (H100 80GB HBM3, 700 W, b256, profile_blocks): a
//   block takes 2.11 ms: the products 1.20 ms (GEMM1 with GELU 0.61, the
//   token product with the gate 0.48, GEMM2 0.11), twice what the same
//   products take with a plain f32 store (0.61 ms): their epilogues (the
//   tanh GELU of 154 M values, the gate's read of u, the f32 stores) run
//   after the wgmmas, not beside them, and are bound by their loads'
//   latency and GELU's arithmetic; the quantize passes take 0.77 ms.
// - GEMM2's N = D = 256 is ragged against the 192-wide tile: TMA zero-fills
//   the weight rows past D and the epilogue skips the columns.
// - The SGU's norm runs on the strided f32 v half of y: its statistics by
//   row_stats_f32, the normalized values recomputed by the token quantize
//   pass (LnF32Src), so vn is never stored.
// - The gate is the token product's epilogue: it adds bs per token and
//   multiplies by u, read at leading dimension 2F; v2 never reaches device
//   memory.

#include "gemm_sm90.cuh"
#include "quant_s8.cuh"

using namespace jmt;

namespace {

// Token-product epilogue at (z, m, n) of (B, N, F):
//   g[z·N + m, n] = u · (v + bs[m]),  u = y[z·N + m, n] at leading dimension ldu.
// row8: eight columns as 16-byte loads and stores where u and g are aligned.
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

  __device__ void row8(long long z, int m, int n, const float* v) const {
    const long long row = z * N + m;
    const float* u = y + row * ldu + n;
    float* o = g + row * F + n;
    if (!aligned16(u) || !aligned16(o)) return (*this)(z, m, n, v, 8);
    const float b = __bfloat162float(bs[m]);
    float uv[8], out[8];
    load8(u, uv);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __fmul_rn(uv[e], __fadd_rn(v[e], b));
    store8(o, out);
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
  using s8gemm::Scales;
  using sm90::gemm_s8;
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
  JMT_CHECK(gemm_s8(s, 1, d.M, F2, d.Dp, w.qxn, d.Dp, 0, qw1, d.Dp, 0,
                    Scales{w.sxn, 0, 1, f32(sw1), 0}, s8gemm::BiasGeluF32{bf(b1), 0, w.y, F2, 0}));
  // the SGU: LN2 of the v half, quantized per image over the tokens; the
  // token product per image (qWsp shared, qv an entry an image), gated by u
  // in its epilogue
  JMT_CHECK(quant::row_stats_f32(s, w.y + F, F2, w.stats, d.M, F));
  JMT_CHECK(quant::quant_cols(s, quant::LnF32Src{w.y + F, F2, w.stats, bf(sgu_w), bf(sgu_b), N},
                              B, N, d.Np, F, w.qv, w.sv));
  JMT_CHECK(gemm_s8(s, B, N, F, d.Np, qwsp, d.Np, 0, w.qv, d.Np, (long long)F * d.Np,
                    Scales{f32(swsp), 0, 1, w.sv, F}, GateF32{w.y, F2, bf(bs), w.g, F, N}));
  // channel project back with the residual
  JMT_CHECK(quant::quant_rows(s, quant::F32Src{w.g, 0, F}, d.M, 1, F, d.Fp, w.qg, w.sg));
  JMT_CHECK(gemm_s8(s, 1, d.M, D, d.Fp, w.qg, d.Fp, 0, qw2, d.Fp, 0,
                    Scales{w.sg, 0, 1, f32(sw2), 0},
                    s8gemm::ResidBias{bf(x), bf(b2), 0, 1, static_cast<bf16*>(out), D, 0}));
  return 0;
}

// Products this library launched on route 2 (the s8 wgmma core) or 3 (the
// mma.sync core), or 0, 1 (the bf16 cores: none), since it was loaded
// (gemm_sm90.cuh); -1 for another route.
extern "C" long long gmlp_int8_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* gmlp_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
