// The Hopper GEMM core (sm_90a) alone, with a plain C interface: the
// checking entries of gemm_sm90.cuh, so that each of its modes can be held
// against its plain version and timed on its own, on either route.
//
// - gemm_tn_bf16: one Mixer channel product (the channel half of
//   jittor_mlp_tpu/ops/pallas/mixer_block.py:157 fused_mixer_block): for
//   A (M, K), B (N, K) and bias (N,), all bf16,
//     act 0:  C = bf16(gelu_tanh(A · Bᵀ + bias))          (GeluBias)
//     act 1:  C = bf16(R + (A · Bᵀ + bias)), R (M, N)     (ResidualBias)
//   on the cooperative schedule or on the handoff one (core 3: the
//   tile's sums handed through shared memory to epilogue warps, which run
//   under the next tile's wgmmas), which kernel 1 runs.
// - gemm_bf16_f32: the bf16 modes of the Mixer channel backward
//   (mixer_block_bwd.py:397 _chan_wgt_bwd): MN-major A and/or B, and K cut
//   into row slabs, one f32 partial each (StoreF32's output); or entries
//   batched or shared (the bf16 gMLP block's token product,
//   gmlp_block.py:57: Wsp shared, vn an N-major entry an image), also on
//   the handoff schedule (core 3), which the gMLP and ResMLP token
//   products run.
// - gemm_s8_f32: the W8A8 products of gmlp_block_int8.py:61 and
//   mixer_block_int8.py:121: int8 A and B, per-row and per-column scales,
//   entries batched or shared, the f32 dequantized product; with a chunk,
//   the chunked mode (the Mixer's second channel product): per-(row, chunk)
//   row scales, the chunks' dequantized sums added in order.
// - gemm_s8_gelu_f32: the same product through the s8 core's GELU epilogue
//   (BiasGeluF32), f32 out: with exact sums, the shared GELU
//   (common.cuh's gelu_tanh) alone, which chip_smoke.py sweeps.
// - gemm_bf16_dual_f32: the dual mode of the Mixer token and channel data
//   backwards (mixer_block_bwd.py:220 _token_bwd's recompute and Wt2ᵀ·dh,
//   :306 _chan_data_bwd's hn·Wc1ᵀ and g·Wc2): two products of one tile,
//   both sums stored in f32.
// - gemm_bf16_group_f32: the Group mode of the token backward's weight
//   gradients (_token_bwd's dWt1, dWt2): a sum over images, a group of
//   images in each tile's K loop, one f32 partial a group.
// with f32 sums. What bounds it and what the design does about it: see
// gemm_sm90.cuh. Nothing on the serving or training path calls these
// entries; the block kernels reach the same core through its templates.

#include "gemm_sm90.cuh"

using namespace jmt;

namespace {

using StoreOut = sm90::StoreEntries;  // out[(z·M + m)·N + n] = v, f32

// The dual check's epilogue: v1 to out[0], v2 to out[1], each (nz, M, N).
struct StoreBoth {
  StoreOut v1, v2;

  __device__ void operator()(long long z, int m, int n, const float* a, const float* b,
                             int cnt) const {
    v1(z, m, n, a, cnt);
    v2(z, m, n, b, cnt);
  }
};

bool valid_core(int core) { return core >= 0 && core <= 2; }

}  // namespace

// One channel product on schedule S and core `which` (gemm_tn_bf16's act).
template <sm90::Sched S>
cudaError_t channel_product(cudaStream_t s, const void* a, const void* b, const void* bias,
                            const void* r, void* c, int M, int N, int K, int act,
                            sm90::Core which) {
  if (act == 0)
    return sm90::gemm_tn<S>(s, M, N, K, a, K, b, K, bf16gemm::gelu_bias(bias, 0, c, N, 0), which);
  if (act == 1)
    return sm90::gemm_tn<S>(s, M, N, K, a, K, b, K, bf16gemm::residual_bias(bias, 0, r, c, N, 0),
                            which);
  return cudaErrorInvalidValue;
}

// All pointers are contiguous bf16 device buffers; r is read for act 1
// only. core: 0 the wgmma core where TMA's rules hold, else the WMMA core;
// 1 the wgmma core (an error where the rules do not hold); 2 the WMMA core
// (0 and 1 on the cooperative schedule); 3 the wgmma core on the handoff
// schedule (an error where the rules do not hold). Returns a cudaError_t
// code (0 on success); cudaErrorInvalidValue for an unknown act or core.
extern "C" int gemm_tn_bf16(const void* a, const void* b, const void* bias, const void* r, void* c,
                            int M, int N, int K, int act, int core, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (core == 3)
    return static_cast<int>(channel_product<sm90::Sched::Handoff>(s, a, b, bias, r, c, M, N, K,
                                                                  act, sm90::Core::Sm90));
  if (!valid_core(core)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(channel_product<sm90::Sched::Coop>(s, a, b, bias, r, c, M, N, K, act,
                                                             static_cast<sm90::Core>(core)));
}

// out (nz, M, N) f32. Slabs (nb 1): nz = ceil(K / slab), partial z =
// op(A)·op(B) over K rows z·slab .. min((z+1)·slab, K) − 1; slab < K (more
// than one partial) needs both operands MN-major: a slab is then a block of
// rows. Entries (slab ≥ K): nz = nb, entry z = op(A_z)·op(B_z), an operand
// batched (a_batched, b_batched: nb matrices one after another) or shared.
// a: bf16 (M, K), or (K, M) with a_mn, rows lda elements apart; b: bf16
// (N, K), or (K, N) with b_mn, rows ldb apart. core as gemm_tn_bf16's: 3
// runs the handoff schedule (the bf16 gMLP and ResMLP blocks' token
// products), which takes a K-major A.
extern "C" int gemm_bf16_f32(const void* a, const void* b, void* out, int nb, int M, int N,
                             int K, int lda, int ldb, int slab, int a_mn, int b_mn,
                             int a_batched, int b_batched, int core, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const bool handoff = core == 3;
  if (!(valid_core(core) || (handoff && !a_mn)) || slab <= 0 || nb <= 0 ||
      (slab < K && !(a_mn && b_mn)) || (slab < K && nb > 1) || lda < (a_mn ? M : K) ||
      ldb < (b_mn ? N : K))
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Core which = handoff ? sm90::Core::Sm90 : static_cast<sm90::Core>(core);
  const bool slabs = slab < K;
  const int nz = slabs ? (K + slab - 1) / slab : nb, kz = slabs ? slab : K;
  const int last = K - (slabs ? nz - 1 : 0) * kz;
  const long long sA = slabs ? (long long)slab * lda
                             : a_batched ? (long long)(a_mn ? K : M) * lda : 0;
  const long long sB = slabs ? (long long)slab * ldb
                             : b_batched ? (long long)(b_mn ? K : N) * ldb : 0;
  const StoreOut epi{static_cast<float*>(out), M, N};
  cudaError_t e;
  if (a_mn && b_mn)
    e = sm90::gemm_bf16<true, true>(s, nz, M, N, kz, last, a, lda, sA, b, ldb, sB, epi, which);
  else if (a_mn)
    e = sm90::gemm_bf16<true, false>(s, nz, M, N, kz, last, a, lda, sA, b, ldb, sB, epi, which);
  else if (b_mn && handoff)
    e = sm90::gemm_bf16<false, true, sm90::Sched::Handoff>(s, nz, M, N, kz, last, a, lda, sA, b,
                                                           ldb, sB, epi, which);
  else if (b_mn)
    e = sm90::gemm_bf16<false, true>(s, nz, M, N, kz, last, a, lda, sA, b, ldb, sB, epi, which);
  else if (handoff)
    e = sm90::gemm_bf16<false, false, sm90::Sched::Handoff>(s, nz, M, N, kz, last, a, lda, sA, b,
                                                            ldb, sB, epi, which);
  else
    e = sm90::gemm_bf16<false, false>(s, nz, M, N, kz, last, a, lda, sA, b, ldb, sB, epi, which);
  return static_cast<int>(e);
}

// out (nz, M, N) f32 = (f32(A_z · B_zᵀ) · rs_z[m]) · cs_z[n]: a int8
// (nz, M, K), or (M, K) shared by every entry when a_batched is 0; b int8
// (nz, N, K) or (N, K); rs f32 (nz, M) or (M); cs f32 (nz, N) or (N); K a
// multiple of 32; contiguous. chunk > 0: K in pieces of chunk codes (a
// multiple of 32 that divides K), rs (nz, M, K / chunk) or (M, K / chunk),
// out = Σ_p (f32(A_z · B_zᵀ over piece p) · rs_z[m, p]) · cs_z[n] in piece
// order (sm90::gemm_s8_chunked). core: 0 or 1 the s8 wgmma core; 2 the
// mma.sync core.
extern "C" int gemm_s8_f32(const void* a, const void* b, const void* rs, const void* cs, void* out,
                           int nz, int M, int N, int K, int chunk, int a_batched, int b_batched,
                           int rs_batched, int cs_batched, int core, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (!valid_core(core) || chunk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pieces = chunk > 0 ? K / chunk : 1;
  const s8gemm::Scales sc{static_cast<const float*>(rs), rs_batched ? (long long)M * pieces : 0,
                          pieces, static_cast<const float*>(cs), cs_batched ? N : 0};
  const long long sA = a_batched ? (long long)M * K : 0, sB = b_batched ? (long long)N * K : 0;
  const StoreOut epi{static_cast<float*>(out), M, N};
  const sm90::Core which = static_cast<sm90::Core>(core);
  if (chunk > 0)
    return static_cast<int>(
        sm90::gemm_s8_chunked(s, nz, M, N, K, chunk, a, K, sA, b, K, sB, sc, epi, which));
  return static_cast<int>(sm90::gemm_s8(s, nz, M, N, K, a, K, sA, b, K, sB, sc, epi, which));
}

// out (M, N) f32 = gelu_tanh(v + bias[n]), v = (f32(A · Bᵀ) · rs[m]) · cs[n]:
// the s8 core's GELU epilogue (s8gemm::BiasGeluF32, which the W8A8 blocks'
// first products run) on a int8 (M, K), b int8 (N, K), rs f32 (M), cs f32
// (N), bias bf16 (N), contiguous, K a multiple of 32. With one nonzero
// code in a row of a and one in b (or none), v is exact: the GELU's f32
// output alone, for checking it. core as gemm_s8_f32's.
extern "C" int gemm_s8_gelu_f32(const void* a, const void* b, const void* rs, const void* cs,
                                const void* bias, void* out, int M, int N, int K, int core,
                                void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (!valid_core(core)) return static_cast<int>(cudaErrorInvalidValue);
  const s8gemm::Scales sc{static_cast<const float*>(rs), 0, 1, static_cast<const float*>(cs), 0};
  const s8gemm::BiasGeluF32 epi{static_cast<const bf16*>(bias), 0, static_cast<float*>(out), N, 0};
  return static_cast<int>(sm90::gemm_s8(s, 1, M, N, K, a, K, 0, b, K, 0, sc, epi,
                                        static_cast<sm90::Core>(core)));
}

// out (2, nz, M, N) f32: out[0] = op(A1_z)·op(B1_z), out[1] = op(A2_z)·op(B2_z)
// through the core's dual mode (sm90::gemm_bf16_dual; on the WMMA core
// out[0] is its f32 scratch). a1, a2: bf16 (M, K), or (K, M) with a_mn,
// rows lda elements apart; b1, b2: (N, K), or (K, N) with b_mn, rows ldb
// apart; each pair's operands batched (nz matrices one after another) or
// shared alike. core as gemm_tn_bf16's.
extern "C" int gemm_bf16_dual_f32(const void* a1, const void* b1, const void* a2, const void* b2,
                                  void* out, int nz, int M, int N, int K, int lda, int ldb,
                                  int a_mn, int b_mn, int a_batched, int b_batched, int core,
                                  void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (!valid_core(core) || nz <= 0 || lda < (a_mn ? M : K) || ldb < (b_mn ? N : K))
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Core which = static_cast<sm90::Core>(core);
  const long long sA = a_batched ? (long long)(a_mn ? K : M) * lda : 0;
  const long long sB = b_batched ? (long long)(b_mn ? K : N) * ldb : 0;
  const sm90::Operand A1{a1, lda, sA}, B1{b1, ldb, sB}, A2{a2, lda, sA}, B2{b2, ldb, sB};
  float* o = static_cast<float*>(out);
  const StoreBoth epi{{o, M, N}, {o + (long long)nz * M * N, M, N}};
  cudaError_t e;
  if (a_mn && b_mn)
    e = sm90::gemm_bf16_dual<true, true>(s, nz, M, N, K, A1, B1, A2, B2, epi, o, which);
  else if (a_mn)
    e = sm90::gemm_bf16_dual<true, false>(s, nz, M, N, K, A1, B1, A2, B2, epi, o, which);
  else if (b_mn)
    e = sm90::gemm_bf16_dual<false, true>(s, nz, M, N, K, A1, B1, A2, B2, epi, o, which);
  else
    e = sm90::gemm_bf16_dual<false, false>(s, nz, M, N, K, A1, B1, A2, B2, epi, o, which);
  return static_cast<int>(e);
}

// out (groups, M, N) f32, groups = ceil(images / per): partial g =
// Σ A_b · B_bᵀ over the images b = g·per .. min((g + 1)·per, images) − 1,
// a bf16 (images, M, K), b (images, N, K), contiguous, through the core's
// Group mode (sm90::gemm_bf16_grouped). core as gemm_tn_bf16's.
extern "C" int gemm_bf16_group_f32(const void* a, const void* b, void* out, int images, int per,
                                   int M, int N, int K, int core, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (!valid_core(core)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sm90::gemm_bf16_grouped(
      s, images, per, M, N, K, a, K, (long long)M * K, b, K, (long long)N * K,
      StoreOut{static_cast<float*>(out), M, N}, static_cast<sm90::Core>(core)));
}

// Products this library launched on route 0 (the bf16 wgmma core), 1 (the
// WMMA core), 2 (the s8 wgmma core) or 3 (the mma.sync core), since it was
// loaded; -1 for another route.
extern "C" long long gemm_tn_products(int route) { return sm90::products(route); }

// The wgmma core's launches by these entries so far in mode `mode` (0
// plain, 1 chunked, 2 dual, 3 Group, 4 handoff); -1 for another mode.
extern "C" long long gemm_mode_launches(int mode) { return sm90::mode_launches(mode); }

// The core's tile (rows, columns, K step in bf16 values), ring stages and
// dynamic shared memory in bytes, then the dual mode's tile columns (K-major
// B), stages and shared memory, then the handoff schedule's tile (rows,
// columns), stages, epilogue warps and shared memory: what = 0 .. 12; -1
// otherwise.
extern "C" long long gemm_sm90_config(int what) {
  const long long v[] = {sm90::BM,      sm90::BN,          sm90::BK,
                         sm90::STAGES,  sm90::SMEM_BYTES,  sm90::BN_DUAL,
                         sm90::DUAL_STAGES, sm90::DUAL_SMEM_BYTES, sm90::HO_BM,
                         sm90::HO_BN,   sm90::HO_STAGES,   sm90::HO_EPI_WARPS,
                         sm90::HandoffTile::SMEM_BYTES};
  return what >= 0 && what < 13 ? v[what] : -1;
}

extern "C" const char* gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
