// W8A8 Mixer block forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/
// mixer_block_int8.py::fused_mixer_block_int8 (body `_kernel_int8`). Every
// product is int8 × int8 → int32 on the s8 wgmma core (gemm_sm90.cuh); weights
// arrive quantized per output channel (the wrapper quantizes them, as the
// JAX wrapper does outside its kernel); activations are quantized here,
// dynamically (quant_s8.cuh). For x (B, N, D) bf16, per image:
//   xn  = LN1(x)                                       f32, not rounded
//   qxn, sxn = quant over the tokens, per column d      (K of the product)
//   t   = gelu_tanh((acc(qWt1 · qxn) · swt1) · sxn + bt1)          f32
//   qt, st = quant over TD, per column d
//   h   = bf16((x + (acc(qWt2 · qt) · swt2) · st) + bt2)
// then over all B·N rows:
//   qhn, shn = quant of LN2(h) (f32) per row, over D
//   c   = gelu_tanh((acc(qhn · qWc1ᵀ) · shn) · swc1 + bc1)           f32
//   qc, sc = quant per (row, chunk of ck columns); ck = CD/4 when CD % 4 = 0
//            and CD ≥ 2048, else CD
//   acc2 = Σ_chunks (acc_chunk(qc · qWc2ᵀ) · sc) · swc2, in chunk order
//   out = bf16(h + (acc2 + bc2))
//
// What bounds it on this card, and what the design does about it:
// - 2·B·N·D·(2·TD + 2·CD) integer operations: 532.7 G at b256 for
//   Mixer-B/16, 0.269 ms at the data sheet's 1,979 dense int8 TOPS.
// - Each activation scale is a reduction over the K axis of the product
//   that consumes the codes, so no GEMM epilogue can quantize its own tile
//   for the next product. Every quantization is a pass of its own between
//   the GEMMs, and the f32 intermediates t (B, TD, D) and c (B·N, CD) go
//   through device memory unrounded, as the reference keeps them in f32:
//   rounding them to bf16 would change the int8 codes. The bytes floor of
//   this data flow (Work below; each pass reads what it consumes once and
//   writes what it makes once), at b256 for Mixer-B/16: t 302 MB written
//   and read, c 617 MB written and read, x read three times (LN1's
//   statistics, its quantize pass, the residual) and h written once and
//   read three times (77 MB each), the codes written and read (qxn 44, qt
//   75, qhn 39, qc 154 MB) and out written: 3.08 GB, 0.918 ms at 3.35
//   TB/s, 3.4× the operation bound. Ten launches per block.
// - The four products run on gemm_sm90.cuh's s8 wgmma core
//   (wgmma...s32.s8.s8, TMA loads of 128-code rows into a four-stage
//   ring, persistent blocks), as the W8A8 gMLP block's do; mma.sync
//   (gemm_s8.cuh), which they replace, reached ≈ 70 TOP/s here. The core
//   dequantizes each tile in its epilogue, (f32(acc) · rs[m]) · cs[n], and
//   hands v to the W8A8 functors of gemm_s8.cuh, so every rounding point
//   is where the reference has it.
// - wgmma's s8 shapes take both operands K-major, so the token products'
//   B operands are written transposed, (B, D, Np) and (B, D, TDp), by the
//   quantize passes, and run per image through the core's batch axis (a
//   3-D tensor map, one entry an image; the weight shared). The token axis
//   N = 196 is padded with zero codes to Np = 224 (a multiple of the
//   wgmma's K, 32), which is exact and makes the rows 16-byte aligned, as
//   TMA needs. The second token product's M = 196 tokens is cut as 192 + 4
//   rows: its second row tile is nearly all zero fill (as in the W8A8
//   gMLP block's token product, which measured that tile at 0.023 ms).
// - The second channel product sums its hidden axis in chunks, one
//   activation scale per (row, chunk): the core's chunked mode keeps an f32
//   running sum beside the s32 sums and flushes each chunk into it where
//   the chunk ends, in chunk order, inside a 128-code K step where ckp is
//   not a multiple of 128 (ck = 514 → ckp = 544 in chip_smoke.py's ragged
//   shape). The running sums cost 48 registers a thread, so that mode's
//   tile is 192×96 (m64n96 consumers) where the others are 192×192.
// - Where the time goes (H100 80GB HBM3, 700 W, b256, profile_blocks): a
//   block takes 2.71 ms (4.85 with its products on mma.sync): the products
//   1.53 ms (the token and channel products with their GELU epilogues and
//   f32 stores of t and c 0.90, the chunked product 0.41, the second token
//   product 0.22), the quantize passes and statistics 0.89 ms, the
//   wrapper's weight quantization most of the rest.
// - No atomics: two calls on the same inputs agree bit for bit.
#include "gemm_sm90.cuh"
#include "quant_s8.cuh"

using namespace jmt;

namespace {

struct Dims {
  int B, N, D, TD, CD, Np, TDp, Dp, ck, ckp, nch, M;

  Dims(int B_, int N_, int D_, int TD_, int CD_) : B(B_), N(N_), D(D_), TD(TD_), CD(CD_) {
    Np = round_up(N, 32);
    TDp = round_up(TD, 32);
    Dp = round_up(D, 32);
    ck = (CD % 4 == 0 && CD >= 2048) ? CD / 4 : CD;
    ckp = round_up(ck, 32);
    nch = CD / ck;
    M = B * N;
  }
};

struct Work {
  float2* stats;
  int8_t* qxn;
  float* sxn;
  float* t;
  int8_t* qt;
  float* st;
  bf16* h;
  int8_t* qhn;
  float* shn;
  float* c;
  int8_t* qc;
  float* sc;

  Work(Carver& w, const Dims& d) {
    const size_t bd = (size_t)d.B * d.D;
    stats = w.take<float2>(d.M);
    qxn = w.take<int8_t>(bd * d.Np);
    sxn = w.take<float>(bd);
    t = w.take<float>(bd * d.TD);
    qt = w.take<int8_t>(bd * d.TDp);
    st = w.take<float>(bd);
    h = w.take<bf16>((size_t)d.M * d.D);
    qhn = w.take<int8_t>((size_t)d.M * d.Dp);
    shn = w.take<float>(d.M);
    c = w.take<float>((size_t)d.M * d.CD);
    qc = w.take<int8_t>((size_t)d.M * d.nch * d.ckp);
    sc = w.take<float>((size_t)d.M * d.nch);
  }
};

}  // namespace

// Bytes of device workspace mixer_block_int8 needs.
extern "C" size_t mixer_block_int8_workspace(int B, int N, int D, int TD, int CD) {
  Carver counter{nullptr};
  const Work work(counter, Dims(B, N, D, TD, CD));
  (void)work;
  return counter.bytes;
}

// x, ln*, bt*, bc*, out: bf16. qwt1 (TD, Np), qwt2 (N, TDp), qwc1 (CD, Dp),
// qwc2 (D, nch·ckp): int8 weights quantized per output channel (row), zero
// in the padding; swt1 (TD), swt2 (N), swc1 (CD), swc2 (D): their f32
// scales. ws: mixer_block_int8_workspace bytes. Returns a cudaError_t code
// (0 on success) from the first launch that failed.
extern "C" int mixer_block_int8(const void* x, const void* ln1w, const void* ln1b,
                                const void* qwt1, const void* swt1, const void* bt1,
                                const void* qwt2, const void* swt2, const void* bt2,
                                const void* ln2w, const void* ln2b, const void* qwc1,
                                const void* swc1, const void* bc1, const void* qwc2,
                                const void* swc2, const void* bc2, void* ws, void* out, int B,
                                int N, int D, int TD, int CD, void* stream_ptr) {
  using s8gemm::Scales;
  using sm90::gemm_s8;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const Dims d(B, N, D, TD, CD);
  Carver carver{static_cast<char*>(ws)};
  const Work w(carver, d);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };

  // token mix, per image (the weight shared, the codes an entry an image)
  JMT_CHECK(quant::row_stats(s, x, w.stats, d.M, D));
  JMT_CHECK(quant::quant_cols(s, quant::LnSrc{bf(x), w.stats, bf(ln1w), bf(ln1b), N, D}, B, N,
                              d.Np, D, w.qxn, w.sxn));
  JMT_CHECK(gemm_s8(s, B, TD, D, d.Np, qwt1, d.Np, 0, w.qxn, d.Np, (long long)D * d.Np,
                    Scales{f32(swt1), 0, 1, w.sxn, D},
                    s8gemm::BiasGeluF32{bf(bt1), 1, w.t, D, (long long)TD * D}));
  JMT_CHECK(quant::quant_cols(s, quant::F32Src{w.t, (long long)TD * D, D}, B, TD, d.TDp, D,
                              w.qt, w.st));
  JMT_CHECK(gemm_s8(s, B, N, D, d.TDp, qwt2, d.TDp, 0, w.qt, d.TDp, (long long)D * d.TDp,
                    Scales{f32(swt2), 0, 1, w.st, D},
                    s8gemm::ResidBias{bf(x), bf(bt2), 1, 0, w.h, D, (long long)N * D}));
  // channel mix over all B·N rows, the hidden axis in chunks
  JMT_CHECK(quant::row_stats(s, w.h, w.stats, d.M, D));
  JMT_CHECK(quant::quant_rows(s, quant::LnSrc{w.h, w.stats, bf(ln2w), bf(ln2b), d.M, D}, d.M,
                              1, D, d.Dp, w.qhn, w.shn));
  JMT_CHECK(gemm_s8(s, 1, d.M, CD, d.Dp, w.qhn, d.Dp, 0, qwc1, d.Dp, 0,
                    Scales{w.shn, 0, 1, f32(swc1), 0},
                    s8gemm::BiasGeluF32{bf(bc1), 0, w.c, CD, 0}));
  JMT_CHECK(quant::quant_rows(s, quant::F32Src{w.c, 0, CD}, d.M, d.nch, d.ck, d.ckp, w.qc,
                              w.sc));
  const int K2 = d.nch * d.ckp;
  JMT_CHECK(sm90::gemm_s8_chunked(
      s, 1, d.M, D, K2, d.ckp, w.qc, K2, 0, qwc2, K2, 0, Scales{w.sc, 0, d.nch, f32(swc2), 0},
      s8gemm::ResidBias{w.h, bf(bc2), 0, 1, static_cast<bf16*>(out), D, 0}));
  return 0;
}

// Products this library launched on route 2 (the s8 wgmma core) or 3 (the
// mma.sync core), or 0, 1 (the bf16 cores: none), since it was loaded
// (gemm_sm90.cuh); -1 for another route.
extern "C" long long mixer_int8_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* mixer_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
