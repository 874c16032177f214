// W8A8 ResMLP block forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/
// resmlp_block_int8.py::fused_resmlp_block_int8 (body `_kernel_int8`), with
// the quantize passes (quant_s8.cuh) of the W8A8 Mixer and gMLP blocks and
// its products on the s8 wgmma core (gemm_sm90.cuh). Weights arrive
// quantized per output channel (the wrapper quantizes them, as the JAX
// wrapper does outside its kernel). For x (B, N, D) bf16, everything stays
// f32 up to the quantizations (nothing is rounded to bf16 before the
// output):
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
//   ResMLP-S24 (N = 196, D = 384, F = 1536), 0.064 ms at the data sheet's
//   1,979 dense int8 TOPS.
// - As in the W8A8 Mixer block, each activation scale is a reduction over
//   the K axis of the product that consumes the codes: the quantizations
//   are passes of their own, and h2 (B, N, D) and c (B·N, F) go through
//   device memory in f32, as the reference keeps them. The bytes floor of
//   this data flow (Work below; each pass reads what it consumes once and
//   writes what it makes once), at b256 for ResMLP-S24: x read twice (the
//   token quantize pass, the token epilogue; 38.5 MB each), h2 written and
//   read twice (its quantize pass, the last residual; 77 MB each), c
//   written and read (308 MB each way), the codes written and read (qh 22,
//   qhb 19, qc 77 MB) and out written: 1.203 GB, 0.359 ms at 3.35 TB/s,
//   5.6× the operation bound. Six launches per block.
// - The three products run on the s8 wgmma core (wgmma.m64n192k32.s32.s8.s8,
//   TMA loads of 128-code rows into a four-stage ring, persistent blocks),
//   where mma.sync (gemm_s8.cuh) ran them before. The core dequantizes
//   each tile in its epilogue, v = (f32(acc) · rs[m]) · cs[n], and hands
//   eight columns to the functors' row8: the same arithmetic as
//   operator(), with 16-byte accesses and every load of the eight columns
//   issued before any is used (the per-column vectors kept packed, as the
//   core's 96 accumulators stay live around the call). Loaded and used one
//   after another, the token epilogue spilled and took 0.23 ms.
// - wgmma's s8 shapes take both operands K-major, so the token product's B
//   operand is written transposed, (B, D, Np), by the token quantize pass,
//   the N = 196 tokens padded with zero codes to Np = 224 (exact; 16-byte
//   rows for TMA). It runs per image through the core's batch axis (a 3-D
//   tensor map, one entry an image; qWt shared): M = 196 tokens cut as
//   192 + 4 rows.
// - FF2 sums its hidden axis in chunks where F ≥ 2048 and F % 4 = 0, one
//   activation scale per (row, chunk): then it takes the core's chunked
//   mode (192×96 tiles, each chunk flushed into an f32 running sum where
//   it ends, inside a 128-code K step where ckp is not a multiple of 128);
//   with one chunk (ResMLP-S24) the 192×192 tile. F alone chooses.
// - Where the time goes (H100 80GB HBM3, 700.00 W, b256): a block takes
//   1.15 ms (chip_smoke.py phase 5; 1.60 with its products on mma.sync);
//   by profile_blocks FF1 with its GELU and the f32 store of c 0.30, the
//   token product with its affine epilogue 0.18, FF2 with the residual
//   0.11, the quantize passes 0.35, the wrapper's weight quantization most
//   of the rest. With a plain f32
//   store the three products take 0.33 ms (chip_smoke.py phase 5; mma.sync
//   0.87, torch._int_mm 0.34 without scales): the epilogues after the
//   wgmmas and the quantize passes, not the products, are what is left.
// - No atomics: two calls on the same inputs agree bit for bit.

#include "gemm_sm90.cuh"
#include "quant_s8.cuh"

using namespace jmt;

namespace {

// Token-mix epilogue: h2 = (h1 + γ1·(v + bt)) · α2 + β2 with h1 = x·α1 + β1,
// stored f32 at (z, m, n) of (B, N, D). row8: eight columns of the s8 wgmma
// core's epilogue, the same arithmetic, with one 16-byte load of x and two
// 16-byte stores of h2 where they are aligned.
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

  __device__ void row8(long long z, int m, int n, const float* v) const {
    const bf16* xs = h1.x + (z * h1.R + m) * h1.cols + n;
    float* o = h2 + z * sz + (long long)m * D + n;
    if (!aligned16(xs) || !aligned16(o)) return (*this)(z, m, n, v, 8);
    // every load first, packed (the core's 96 accumulators stay live)
    const uint4 xr = *reinterpret_cast<const uint4*>(xs);
    const uint4 a1v = col8(h1.a, n), b1v = col8(h1.b, n), g1v = col8(g1, n);
    const uint4 a2v = col8(a2, n), b2v = col8(b2, n);
    const float b = __bfloat162float(bt[m]);
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = __fadd_rn(__fmul_rn(at8(xr, e), at8(a1v, e)), at8(b1v, e));  // h1, as AffSrc
      const float hh = __fadd_rn(h, __fmul_rn(at8(g1v, e), __fadd_rn(v[e], b)));
      y[e] = __fadd_rn(__fmul_rn(hh, at8(a2v, e)), at8(b2v, e));
    }
    store8(o, y);
  }
};

// Output epilogue: out = bf16(h2 + γ2 · (v + c2)), (B·N, D). row8: eight
// columns, the same arithmetic, with two 16-byte loads of h2 and one
// 16-byte store where they are aligned.
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

  __device__ void row8(long long z, int m, int n, const float* v) const {
    const long long o = (long long)m * D + n;
    if (!aligned16(h2 + o) || !aligned16(out + o)) return (*this)(z, m, n, v, 8);
    float r[8], y[8];
    load8(h2 + o, r);
    const uint4 g2v = col8(g2, n), c2v = col8(c2, n);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = __fadd_rn(r[e], __fmul_rn(at8(g2v, e), __fadd_rn(v[e], at8(c2v, e))));
    store8(out + o, y);
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
  using s8gemm::Scales;
  using sm90::gemm_s8;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const Dims d(B, N, D, F);
  Carver carver{static_cast<char*>(ws)};
  const Work w(carver, d);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const quant::AffSrc h1{bf(x), bf(a1), bf(b1), N, D};

  // token mix, per image (qWt shared, the codes an entry an image)
  JMT_CHECK(quant::quant_cols(s, h1, B, N, d.Np, D, w.qh, w.sh));
  JMT_CHECK(gemm_s8(s, B, N, D, d.Np, qwt, d.Np, 0, w.qh, d.Np, (long long)D * d.Np,
                    Scales{f32(swt), 0, 1, w.sh, D},
                    TokenAffine{h1, bf(bt), bf(g1), bf(a2), bf(b2), w.h2, D, (long long)N * D}));
  // channel FF over all B·N rows, the hidden axis in chunks
  JMT_CHECK(quant::quant_rows(s, quant::F32Src{w.h2, 0, D}, d.M, 1, D, d.Dp, w.qhb, w.shb));
  JMT_CHECK(gemm_s8(s, 1, d.M, F, d.Dp, w.qhb, d.Dp, 0, qw1, d.Dp, 0,
                    Scales{w.shb, 0, 1, f32(sw1), 0},
                    s8gemm::BiasGeluF32{bf(c1), 0, w.c, F, 0}));
  JMT_CHECK(quant::quant_rows(s, quant::F32Src{w.c, 0, F}, d.M, d.nch, d.ck, d.ckp, w.qc,
                              w.sc));
  const int K2 = d.nch * d.ckp;
  const Scales s2{w.sc, 0, d.nch, f32(sw2), 0};
  const ScaledResid resid{w.h2, bf(g2), bf(c2), static_cast<bf16*>(out), D};
  // one chunk: the 192×192 tile; several: the chunked mode (192×96 tiles,
  // each chunk flushed in the core where it ends), chosen by F alone
  JMT_CHECK(d.nch == 1
                ? gemm_s8(s, 1, d.M, D, K2, w.qc, K2, 0, qw2, K2, 0, s2, resid)
                : sm90::gemm_s8_chunked(s, 1, d.M, D, K2, d.ckp, w.qc, K2, 0, qw2, K2, 0, s2,
                                        resid));
  return 0;
}

// Products this library launched on route 2 (the s8 wgmma core) or 3 (the
// mma.sync core), or 0, 1 (the bf16 cores: none), since it was loaded
// (gemm_sm90.cuh); -1 for another route.
extern "C" long long resmlp_int8_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* resmlp_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
