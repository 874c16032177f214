// gMLP block forward in bf16 for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/gmlp_block.py::
// fused_gmlp_block (body `_kernel`). For x (B, N, D), with the same
// rounding points:
//   xn  = bf16(LN1(x))                                   f32 stats and affine
//   y   = bf16(gelu_tanh(xn · W1ᵀ + b1))                 W1 (2F, D), rows B·N
//   u, v = y[:, :F], y[:, F:]
//   vn  = bf16(LN2(v))                                   the SGU's norm
//   v2  = bf16(Wsp · vn + bs)                            Wsp (N, N), per image
//   g   = bf16(f32(u) · f32(v2))
//   out = bf16(x + (g · W2ᵀ + b2))                       W2 (D, F)
// All products accumulate in f32 on the tensor cores, on gemm_sm90.cuh's
// bf16 wgmma core with gMLP epilogues.
//
// What bounds it on this card, and what the design does about it:
// - 2·B·N·(D·2F + N·F + F·D) flops: 148.6 G at b256 for gMLP-S (N = 196,
//   D = 256, F = 1536), 0.150 ms at the data sheet's 989 dense bf16 TFLOP/s.
//   The two channel products carry 80% of them and stack all B·N rows into
//   one M; the token product carries the other 20%.
// - No VMEM: the block is five launches (LN1, GEMM1, LN2 over the v half,
//   token GEMM, GEMM2); xn, y, vn and g go through device memory in bf16,
//   as the TPU kernel rounds them; the weights are shared by every image
//   and stay in the 50 MB L2 cache. The bytes floor of this data flow at
//   b256 for gMLP-S: y written (308 MB), its v half read by LN2 and its u
//   half by the gate (154 MB each), vn and g written and read (154 MB each
//   way), x read twice (LN1, the residual), xn written and read and out
//   written (26 MB each): 1.36 GB, 0.406 ms at 3.35 TB/s, 2.7× the
//   operation bound.
// - The three products run on the wgmma core (TMA loads, wgmma from
//   warp-specialized warpgroups, persistent blocks), where the WMMA core
//   (gemm_bf16.cuh) ran them before. GEMM1 (K = D = 256, four K steps of
//   64) is bound by its epilogue, the tanh GELU of B·N·2F values and their
//   308 MB of bf16 stores at b256: it runs on the core's handoff schedule,
//   which hands each 128×192 tile's sums to eleven epilogue warps under the
//   next tile's wgmmas, and the GELU is common.cuh's x·σ(2u) on the
//   special-function unit (two ops a value, where libm's tanhf took about
//   45). GEMM2, whose residual epilogue is short, keeps the cooperative
//   schedule (0.134 ms against 0.139 on the handoff one at b256); its
//   N = D = 256 is ragged against the 192-wide tile (TMA zero fill, the
//   epilogue skips the columns).
// - The token product is per image through the core's batch axis, M = K =
//   N = 196, with Wsp as the shared A operand and vn as an N-major B (K × F
//   row-major per image, wgmma's transpose bit: the TB mode, a 3-D tensor
//   map for every image but the last so that no image reads the next one's
//   rows). Wsp's 392-byte rows break TMA's 16-byte stride rule, so each call
//   first copies Wsp into rows of Np = round_up(N, 8) elements (400 bytes),
//   zero in the padding (the JAX wrapper pads its K axis to 128 the same
//   way); K stays N, and TMA zero-fills the K tail. It runs on the handoff
//   schedule's batched mode: 128-row tiles cut the 196 tokens as 128 + 68
//   (the cooperative 192-row tile cut them 192 + 4, almost a whole tile of
//   zero fill), an image's two row tiles of each column slab back to back
//   so that vn is read from device memory once, and the gate under the
//   next tile's wgmmas.
// - Where TMA's rules fail (D or F not a multiple of 8: rows that are not
//   16-byte multiples apart) a product takes the WMMA core on the same
//   arguments, a route counted by gmlp_gemm_products as the wgmma one is.
// - The gate is the token product's epilogue: it reads u at leading
//   dimension 2F, adds bs per token, rounds v2 to bf16 and writes g, so v2
//   never reaches device memory.
// - Where the time goes (H100 80GB HBM3, 700 W, b256, profile_blocks): a
//   block takes about 0.90 ms (1.05 before its GELU and token products took
//   the handoff schedule and the SFU GELU; 1.48 with its products on WMMA):
//   the token product with the gate 0.32, GEMM1 with GELU 0.28, the two
//   LayerNorms 0.15, GEMM2 0.13. The token product and GEMM1 are bound by
//   their epilogues (their MMA warpgroup waits for the epilogue warps 61%
//   and 47% of its time, tools/handoff_variants.py): above all u, read from
//   device memory by the gate a run at a time (0.18 ms of the block), and
//   the GELU's bias loads and stores; the token product moves its 462 MB
//   of vn, u and g at about 1.4 TB/s.
// - No atomics: two calls on the same inputs agree bit for bit.

#include "gemm_sm90.cuh"
#include "layer_norm.cuh"

using namespace jmt;

namespace {

// Token-product epilogue at (z, m, n) of (B, N, F):
//   v2 = bf16(v + bs[m]);  g = bf16(f32(u) · f32(v2)),
// u = y[z·N + m, n] at leading dimension ldu (2F); g (B·N, F). vec: u and g
// allow 16-byte access.
struct Gate {
  const bf16* y;
  int ldu;
  const bf16* bs;
  bf16* g;
  int F, N;
  bool vec;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const long long row = z * N + m;
    const bf16* u = y + row * ldu + n;
    bf16* o = g + row * F + n;
    const float b = __bfloat162float(bs[m]);
    if (vec && cnt == 8) {  // one 16-byte load of u, one 16-byte store of g
      const uint4 uu = *reinterpret_cast<const uint4*>(u);
      const bf16* uv = reinterpret_cast<const bf16*>(&uu);
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v2 = __bfloat162float(__float2bfloat16(__fadd_rn(v[e], b)));
        ov[e] = __float2bfloat16(__fmul_rn(__bfloat162float(uv[e]), v2));
      }
      *reinterpret_cast<uint4*>(o) = out;
    } else {
      for (int e = 0; e < cnt; ++e) {
        const float v2 = __bfloat162float(__float2bfloat16(__fadd_rn(v[e], b)));
        o[e] = __float2bfloat16(__fmul_rn(__bfloat162float(u[e]), v2));
      }
    }
  }
};

struct Work {
  bf16* wsp;  // Wsp in rows of Np
  bf16* xn;
  bf16* y;
  bf16* vn;
  bf16* g;

  Work(Carver& w, int B, int N, int D, int F) {
    const size_t M = (size_t)B * N;
    wsp = w.take<bf16>((size_t)N * round_up(N, 8));
    xn = w.take<bf16>(M * D);
    y = w.take<bf16>(M * 2 * F);
    vn = w.take<bf16>(M * F);
    g = w.take<bf16>(M * F);
  }
};

}  // namespace

// Bytes of device workspace gmlp_block_bf16 needs.
extern "C" size_t gmlp_block_bf16_workspace(int B, int N, int D, int F) {
  Carver counter{nullptr};
  const Work work(counter, B, N, D, F);
  (void)work;
  return counter.bytes;
}

// All tensors bf16, contiguous: x (B, N, D), ln1w/ln1b/b2 (D), w1 (2F, D),
// b1 (2F), sgu_w/sgu_b (F), wsp (N, N), bs (N), w2 (D, F). ws:
// gmlp_block_bf16_workspace bytes. Returns a cudaError_t code (0 on
// success) from the first call that failed.
extern "C" int gmlp_block_bf16(const void* x, const void* ln1w, const void* ln1b, const void* w1,
                               const void* b1, const void* sgu_w, const void* sgu_b,
                               const void* wsp, const void* bs, const void* w2, const void* b2,
                               void* ws, void* out, int B, int N, int D, int F,
                               void* stream_ptr) {
  using bf16gemm::gelu_bias;
  using bf16gemm::residual_bias;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  Carver carver{static_cast<char*>(ws)};
  const Work w(carver, B, N, D, F);
  const int M = B * N, Np = round_up(N, 8), F2 = 2 * F;

  // Wsp → rows of Np, zero past column N
  JMT_CHECK(cudaMemsetAsync(w.wsp, 0, sizeof(bf16) * N * Np, s));
  JMT_CHECK(cudaMemcpy2DAsync(w.wsp, sizeof(bf16) * Np, wsp, sizeof(bf16) * N,
                              sizeof(bf16) * N, N, cudaMemcpyDeviceToDevice, s));
  JMT_CHECK(layer_norm(s, x, D, ln1w, ln1b, w.xn, M, D));
  // channel expand over all B·N rows: y = gelu(xn · W1ᵀ + b1), (B·N, 2F),
  // its GELU epilogue under the next tile's wgmmas
  JMT_CHECK(sm90::gemm_tn<sm90::Sched::Handoff>(s, M, F2, D, w.xn, D, w1, D,
                                                 gelu_bias(b1, 0, w.y, F2, 0)));
  // the SGU: vn = LN2(v), v the second half of each row of y
  JMT_CHECK(layer_norm(s, w.y + F, F2, sgu_w, sgu_b, w.vn, M, F));
  // token product per image, gated: g = u · bf16(Wsp · vn + bs); Wsp shared,
  // vn (K = N tokens × F per image) N-major; the gate under the next tile's
  // wgmmas, an image's two row tiles of each column slab back to back
  const Gate gate{w.y, F2, static_cast<const bf16*>(bs), w.g, F, N,
                  vec_ok(w.y, F2, 0) && vec_ok(w.g, F, 0)};
  JMT_CHECK((sm90::gemm_bf16<false, true, sm90::Sched::Handoff>(s, B, N, F, N, N, w.wsp, Np, 0,
                                                                w.vn, F, (long long)N * F, gate)));
  // channel project back with the residual: out = x + (g · W2ᵀ + b2)
  JMT_CHECK(sm90::gemm_tn(s, M, D, F, w.g, F, w2, F, residual_bias(b2, 0, x, out, D, 0)));
  return 0;
}

// Products this library launched on route 0 (the bf16 wgmma core) or 1
// (the WMMA core), since it was loaded (gemm_sm90.cuh); -1 for another
// route.
extern "C" long long gmlp_gemm_products(int route) { return sm90::products(route); }

// The wgmma core's launches by this library so far in mode `mode` (0 plain:
// GEMM2; 4 handoff: GEMM1 and the token product); -1 for another mode.
extern "C" long long gmlp_mode_launches(int mode) { return sm90::mode_launches(mode); }

extern "C" const char* gmlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
