// A Hopper GEMM core (sm_90a): TMA loads into a 128-byte-swizzled
// mbarrier ring, wgmma from warp-specialized warpgroups, persistent blocks.
//
//   C[z] = epi(z, op(A[z]) · op(B[z])),   z = 0 .. nz−1
//
// bf16 operands with f32 sums (wgmma m64n192k16), or int8 operands with
// s32 sums (wgmma m64n192k32 .s32.s8.s8; m64n96k32 in the chunked mode).
// op(A) is M×K: A stored M×K
// row-major (K-major) or, with TA, K×M row-major (MN-major, read through
// wgmma's transpose); op(B) is K×N: B stored N×K row-major (K-major, a
// torch Linear weight) or, with TB, K×N row-major (MN-major). wgmma's s8
// shapes have no transpose: int8 operands are K-major. Entry z of an
// operand is the matrix at p + z·zstride elements (zstride 0: one matrix
// shared by every entry). Every entry has the same K but the last, whose K
// may be shorter (K_last): a sum over K cut into row slabs, one f32 partial
// per slab written by the epilogue at its z and added by the caller in a
// fixed order, is split-K without atomics.
//
// The epilogue is gemm_bf16.cuh's functor, unchanged:
//   void operator()(long long z, int m, int n, const float* v, int cnt) const
// gets the f32 sums of row m, columns n .. n+cnt-1 of entry z (n % 8 == 0,
// cnt ≤ 8). So GeluBias, ResidualBias, the gMLP gate, the Mixer backward's
// BiasPreact, GeluGrad and StoreF32 and the kernel lab's epilogues plug in
// as they are. gemm_s8 wraps the W8A8 functors of gemm_s8.cuh (BiasGeluF32,
// ResidBias, the gMLP gate) in Dequant, which hands them
// v = (f32(acc) · rs[m]) · cs[n] with gemm_s8.cuh's rounding (eight columns
// through their row8, the same arithmetic as operator() with 16-byte
// accesses; mma.sync's calls of operator() are unchanged); so every
// rounding point of a block stays where it was.
//
// The chunked s8 mode (gemm_s8_chunked) is gemm_s8.cuh's chunk flush in the
// core: K is cut into pieces of `chunk` codes (a multiple of 32 that divides
// K), and where a piece ends, after any of a K step's four k32 wgmmas, the
// consumer retires its wgmmas, adds (f32(acc) · rs[m, piece]) · cs[n] into
// an f32 running sum in piece order, v = ((0 + p0) + p1) + …, and zeroes the
// s32 sums; the epilogue hands v to the functor unchanged. The running sums
// need 48 more registers a thread beside the s32 sums: the mode's tile is
// 192×96 (three m64n96 consumers, 48 + 48 a thread, within the 128 that
// four warpgroups leave) rather than two consumers of m64n192 at 232
// registers each after setmaxnreg, which ptxas would have to honour
// (ptxas -v: 128 registers, no spills). Measured on an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 5, f32 output): the W8A8 Mixer-B/16's second
// channel product at b256, (50176, 768, 3072) in 4 chunks of 768 codes,
// 0.3781 ms, 626 TOP/s (mma.sync 1.0171 ms; torch._int_mm's whole product,
// without chunks or scales, 0.3219). The design not taken: each piece as
// an f32 partial through device memory, summed by a later pass (4 × 154 MB
// more traffic at Mixer-B/16 b256, about 0.3 ms a block).
//
// The dual mode (gemm_bf16_dual) computes two products of one shape and
// reading on one output tile, C = epi(z, m, n, v1, v2) with
// v1 = op(A1)·op(B1) and v2 = op(A2)·op(B2), so that an epilogue that needs
// both (the Mixer backwards' act'(cp) · dc) keeps them in registers. It
// carries two accumulator sets: 192×96 tiles of three m64n96 consumers
// (48 + 48 f32 a thread, the chunked mode's answer to the register budget;
// ptxas -v: 128 registers, no spills), or 192×64 (m64n64) where B is
// MN-major, one 64-value swizzle atom wide. Each ring stage holds A1, B1,
// A2 and B2: 72 KB (64 KB at 192×64), so the ring has 3 stages (216 KB of
// the 227 KB; a fourth does not fit), and the epilogue moves the sums
// between the lanes of a quad (a 4 × 4 transpose of column pairs by two
// shuffles) instead of staging them, which leaves shared memory to the
// third stage. Entries are batched or shared as in the plain mode (every
// entry has the same K: one map over all entries, 3-D where batched).
//
// The Group mode (gemm_bf16_grouped) sums a product over images in groups,
// C[g] = Σ_{b in group g} A_b · B_bᵀ, both operands K-major per image
// (K = each image's own axis, the images an outer stride): each tile's K
// loop walks (image, K step) through the operands' 3-D tensor maps, so a
// box never straddles two images and an image's K tail reads zeros; each
// group's sum goes to the epilogue at its z (one f32 partial a group,
// added by the caller in a fixed order: no atomics, two calls bit-equal).
// The group size comes from the output's tile count and the SM count
// (images_per_group). Row slabs (the plain mode's split-K) need the
// contraction axis to be the contiguous rows; here it is each image's D
// axis.
//
// Which TPU work it serves: the four products of
// jittor_mlp_tpu/ops/pallas/mixer_block.py:157 fused_mixer_block (kernel 1,
// mixer_block.cu, and the forward-with-h, through mixer_forward.cuh: the
// token products an entry an image with an N-major B) and the four
// products of the kernel lab's bodies (the same code; the wide and
// token-major bodies' token products an entry a group of images); the
// four products of mixer_block_bwd.py:397 _chan_wgt_bwd and the two it
// shares with :306 _chan_data_bwd (mixer_block_bwd.cu); the three int8
// products of gmlp_block_int8.py:61 fused_gmlp_block_int8
// (gmlp_block_int8.cu); the four int8 products of mixer_block_int8.py:121
// fused_mixer_block_int8, the second channel product in the chunked mode
// (mixer_block_int8.cu); the three bf16 products of gmlp_block.py:57
// fused_gmlp_block, the token product with an MN-major B (gmlp_block.cu);
// the three bf16 products of resmlp_block.py:54 fused_resmlp_block, the
// token product with an MN-major B (resmlp_block.cu), and the three int8
// products of resmlp_block_int8.py:69 fused_resmlp_block_int8, the second
// in the chunked mode where F is chunked (resmlp_block_int8.cu); the five
// products of mixer_block_bwd.py:220 _token_bwd (a dual product an image,
// dWt1 and dWt2 in the Group mode, dxn) and the three of :306
// _chan_data_bwd (a dual product, dhn) (mixer_block_bwd.cu).
//
// What bounds it: the Mixer-B/16 channel products at b256 are 236.8 GFLOP
// each, 0.239 ms at the H100's 989 TFLOP/s dense bf16 peak, against 0.1–0.4
// GB of operands and output: bound by operations, and only wgmma reaches
// that rate (the WMMA core ran them at ≈ 160 TFLOP/s, mma.sync's s8 GEMM
// the gMLP products at ≈ 70 TOP/s). Where an epilogue reads and writes f32
// intermediates (the backward's cp, the W8A8 gMLP's y and g) the bytes
// bound instead. Measured at b256 on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 5, f32 output, two runs): the Mixer backward's slab
// products (MN-major operands) at 762–789 TFLOP/s, its K-major and N-major
// B ones at 459–479; the gMLP's int8 products at 138–516 TOP/s, 2.3–2.7×
// mma.sync, each 1.6–2.1× its bytes bound. What the design does about it:
// - Loads: TMA (cp.async.bulk.tensor, the CUtensorMaps __grid_constant__
//   parameters) of one 128-byte row of each operand row per K step (64 bf16
//   or 128 int8 values) into 128-byte-swizzled shared memory aligned to
//   1024 bytes, the layout wgmma reads through its descriptors. A K-major
//   operand is one box of 192 rows (B's 96 in the chunked mode); an
//   MN-major one three boxes of 64 values × 64 K rows, 8 KB apart (the
//   descriptor's leading byte offset),
//   read with wgmma's transpose bit. Ragged M, N and K tails are TMA's
//   zero fill: the main loop has no masks, and the epilogue skips rows ≥ M
//   and columns ≥ N. A batched operand has two maps: a 3-D one (columns,
//   rows, entries) for every entry but the last, so that a slab's K tail
//   reads zeros and not the next slab's rows, and a 2-D one for the last.
// - Pipeline: a ring of STAGES = 4 stages (48 KB each; the dual mode 3 of
//   72 or 64 KB) with full and empty mbarriers. One producer thread (warpgroup 0, which gives up registers
//   with setmaxnreg) keeps the TMA loads in flight; three consumer
//   warpgroups each run wgmma.m64n192 on their 64 rows of the 192×192
//   block tile, four per K step, and keep one step's wgmmas in flight: a
//   stage goes back to the producer only after the wgmmas that read it have
//   retired (wait_group 1, then an arrive on its empty barrier from each
//   consumer warp).
// - The tile: the L2 feeds 48 KB a K step for 4.7 M multiply-adds (98
//   operations a byte in bf16; 128×256 with two consumers measured slower
//   on the card), and the consumers' 96 accumulators a thread fit the 128
//   registers that four warpgroups leave (m64n256 needs 154).
// - Persistent blocks, one per SM (the ring and staging take 220 KB of
//   shared memory), walk the output tiles (entry, then rows, then columns)
//   with a stride of the grid, so the producer loads the next tile while
//   the consumers run this one's epilogue.
// - Epilogue: wgmma's accumulator spreads a row's 8 columns over the 4
//   lanes of a quad, so each consumer warp stages its 16 rows 32 columns at
//   a time, as f32, through 2.3 KB of shared memory, and 4 lanes then hand
//   one row's 32 columns to the functor. The epilogue does not overlap this
//   block's wgmmas.
// - Deterministic: no atomics. Each output element is one tile's sum over
//   its entry's K in a fixed order, whatever the grid: two calls agree bit
//   for bit.
//
// Routes, both hand-written and both counted (products(route), a dual
// launch two; wgmma launches also per mode, mode_launches): bf16 takes the
// wgmma core where TMA's rules hold (bases 16-byte aligned, row and entry
// strides multiples of 16 bytes), else bf16gemm's WMMA core on the same
// arguments (a dual product as two products, v1 through an f32 buffer the
// caller gives; the Group mode as gemm_sum). int8 takes the s8 wgmma core always: s8gemm's
// mma.sync core, which it replaces, takes only operands whose rows are
// 16-byte aligned, which TMA loads too; mma.sync stays for comparison
// (Core::Legacy). cuTensorMapEncodeTiled is looked up in libcuda at run
// time (the runtime's entry-point query), so the library needs no -lcuda.
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000

#include <algorithm>
#include <atomic>

#include "gemm_bf16.cuh"
#include "gemm_s8.cuh"

namespace jmt {
namespace sm90 {

constexpr int CONSUMERS = 3;                      // warpgroups of 64 tile rows each
constexpr int BM = 64 * CONSUMERS, BN = 192;      // block tile
constexpr int BN_CHUNKED = 96;                    // the chunked s8 mode's tile width
constexpr int K_BYTES = 128;                      // a K step: one 128-byte row of each operand row
constexpr int BK = K_BYTES / 2;                   // ... 64 bf16 values (128 int8)
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (1 + CONSUMERS);    // warpgroup 0 produces
// setmaxnreg: 128·40 + 384·152 = 63,488 of the 512·128 the launch bounds give
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 152;
constexpr int A_BYTES = BM * K_BYTES;             // 24 KB
constexpr int MN_LBO = BK * K_BYTES;              // MN-major: 64-value chunks one 8 KB box apart
constexpr int STG_LD = 36;                        // f32 row of a warp's 16×32 staging tile
constexpr int STG_FLOATS = 16 * STG_LD;

constexpr int BN_DUAL = 96;                       // the dual mode's tile width (K-major B)
constexpr int BN_DUAL_MN = 64;                    // ... with an MN-major B: one swizzle atom
constexpr int DUAL_STAGES = 3;                    // the dual mode's ring

// The geometry of a block tile W columns wide with PAIRS products (two in
// the dual mode): each consumer thread holds W / 2 sums of each product; a
// stage is, for each product, A's 192 rows and B's W rows of one K step
// (an MN-major B in boxes of 64 values). One product stages its sums
// through shared memory; the dual mode moves them between the lanes of a
// quad instead (quad_run), which leaves room for a third stage.
template <int W, int PAIRS = 1, bool TB = false>
struct Tile {
  static constexpr int ACC = W / 2;
  static constexpr int B_BYTES = (TB ? (W + 63) / 64 * 64 : W) * K_BYTES;
  static constexpr int PAIR_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGE_BYTES = PAIRS * PAIR_BYTES;
  static constexpr int NSTAGES = PAIRS == 1 ? STAGES : DUAL_STAGES;
  static constexpr int STG_BYTES = PAIRS == 1 ? CONSUMERS * 4 * STG_FLOATS * 4 : 0;
  // alignment slack, ring, staging, barriers
  static constexpr int SMEM_BYTES = 1024 + NSTAGES * STAGE_BYTES + STG_BYTES + 2 * NSTAGES * 8;
  static_assert(W % 32 == 0 && PAIR_BYTES % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(SMEM_BYTES <= 232448, "the ring fits the 227 KB a block may use");
};
constexpr int SMEM_BYTES = Tile<BN>::SMEM_BYTES;  // 48 KB stages; 36 KB in the chunked mode
// the dual mode: 3 stages of 72 KB (192×96 tiles, K-major B: 217 KB with
// the barriers and the alignment slack) or of 64 KB (192×64, MN-major B),
// no staging; a fourth stage does not fit
constexpr int DUAL_SMEM_BYTES = Tile<BN_DUAL, 2>::SMEM_BYTES;
static_assert(Tile<BN_DUAL_MN, 2, true>::SMEM_BYTES <= DUAL_SMEM_BYTES, "either dual tile fits");
static_assert(BN == 192 && BN_CHUNKED == 96 && BN_DUAL == 96 && BN_DUAL_MN == 64,
              "the consumers' wgmma is m64n192 (m64n96 chunked and dual, m64n64 dual MN-major)");

// The kernel's modes: one product a tile (Plain), the chunked s8 mode, two
// products of one tile (Dual), one product summed over a group of images
// in the K loop (Group).
enum class Mode { Plain = 0, Chunked = 1, Dual = 2, Group = 3 };

// The block tile's width of a mode.
template <Mode MODE, bool TB>
constexpr int TILE_W = MODE == Mode::Chunked ? BN_CHUNKED
                       : MODE == Mode::Dual  ? (TB ? BN_DUAL_MN : BN_DUAL)
                                             : BN;

// bf16 on wgmma and on the WMMA core; int8 on wgmma and on mma.sync.
enum Route { SM90 = 0, WMMA = 1, SM90_S8 = 2, MMA_S8 = 3 };
// Auto: the wgmma core where TMA's rules hold, else the core it replaces;
// Sm90 forces the wgmma core (an error where the rules do not hold);
// Legacy the core it replaces (WMMA for bf16, mma.sync for int8).
enum class Core { Auto = 0, Sm90 = 1, Legacy = 2 };

// Products launched per route, and wgmma-core launches per Mode, in this
// library (internal linkage: each kernel library is one translation unit
// and keeps its own counts). A dual launch is two products.
static std::atomic<long long> g_products[4];
static std::atomic<long long> g_modes[4];

inline long long products(int route) {
  return route >= 0 && route < 4 ? g_products[route].load() : -1;
}

inline long long mode_launches(int mode) {
  return mode >= 0 && mode < 4 ? g_modes[mode].load() : -1;
}

template <class T>
struct Elem;

template <>
struct Elem<bf16> {
  typedef float Acc;
  static constexpr int K_INST = 16;  // one wgmma's K: 32 bytes
  static constexpr Route WGMMA = SM90;
  static CUtensorMapDataType tma_type() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
};

template <>
struct Elem<int8_t> {
  typedef int Acc;
  static constexpr int K_INST = 32;
  static constexpr Route WGMMA = SM90_S8;
  static CUtensorMapDataType tma_type() { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One box of a tensor map (x: column, y: row, z: entry of a 3-D map) into
// shared memory; the bytes land on `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         bool two_d, uint64_t* bar) {
  if (two_d)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
        : "memory");
}

// wgmma descriptor of a tile in the 128-byte swizzle (layout type 1): start
// address, leading byte offset `lbo` (MN-major: the next 64-value chunk of
// M or N; unused by the K-major layout), stride 1024 bytes between 8-row
// groups (rows of M or N K-major, rows of K MN-major). The tile is
// 1024-aligned; K-major, +32 bytes of start address is the next wgmma's K
// slice; MN-major, +K_INST rows of 128 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 96 accumulator registers of one m64n192 wgmma, as operands %0..%95.
#define JMT_WGMMA_D96                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "  \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "  \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "  \
  "%91, %92, %93, %94, %95}"
#define JMT_WGMMA_OUT96(C)                                                                   \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]), C(d[9]),  \
      C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]),        \
      C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]),        \
      C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]),        \
      C(d[34]), C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]),        \
      C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]),        \
      C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]), C(d[57]),        \
      C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63]), C(d[64]), C(d[65]),        \
      C(d[66]), C(d[67]), C(d[68]), C(d[69]), C(d[70]), C(d[71]), C(d[72]), C(d[73]),        \
      C(d[74]), C(d[75]), C(d[76]), C(d[77]), C(d[78]), C(d[79]), C(d[80]), C(d[81]),        \
      C(d[82]), C(d[83]), C(d[84]), C(d[85]), C(d[86]), C(d[87]), C(d[88]), C(d[89]),        \
      C(d[90]), C(d[91]), C(d[92]), C(d[93]), C(d[94]), C(d[95])

// d (64×192, f32) += op(A) (64×16, desc a) · op(B) (16×192, desc b) for one
// warpgroup; TA, TB: the operand is MN-major (wgmma's imm-trans-a, -b).
// d[4j + 2i + c] holds row 16·warp + lane/4 + 8i, column 8j + 2·(lane % 4) + c.
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " JMT_WGMMA_D96
      ", %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : JMT_WGMMA_OUT96("+f")
      : "l"(a), "l"(b), "r"(1), "n"(TA ? 1 : 0), "n"(TB ? 1 : 0));
}

// d (64×192, s32) += A (64×32 int8, K-major) · B (192×32 int8, K-major)ᵀ;
// the accumulator layout of the bf16 form.
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_192(int (&d)[96], uint64_t a, uint64_t b) {
  static_assert(!TA && !TB, "wgmma's s8 shapes read K-major operands only");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " JMT_WGMMA_D96 ", %96, %97, p;\n"
      "}\n"
      : JMT_WGMMA_OUT96("+r")
      : "l"(a), "l"(b), "r"(1));
}

#undef JMT_WGMMA_D96
#undef JMT_WGMMA_OUT96

// The 48 accumulator registers of one m64n96 wgmma, as operands %0..%47.
#define JMT_WGMMA_D48 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47}"
#define JMT_WGMMA_OUT48(C) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), \
  C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), \
  C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), \
  C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), \
  C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), \
  C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), \
  C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47])

// d (64×96, s32) += A (64×32 int8, K-major) · B (96×32 int8, K-major)ᵀ: the
// chunked mode's wgmma; d[4j + 2i + c] as in the m64n192 forms, j < 12.
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_96(int (&d)[48], uint64_t a, uint64_t b) {
  static_assert(!TA && !TB, "wgmma's s8 shapes read K-major operands only");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 " JMT_WGMMA_D48 ", %48, %49, p;\n"
      "}\n"
      : JMT_WGMMA_OUT48("+r")
      : "l"(a), "l"(b), "r"(1));
}

// d (64×96, f32) += op(A) (64×16) · op(B) (16×96), bf16: the dual mode's
// wgmma, TA and TB as wgmma_192's; d[4j + 2i + c] as in the m64n192 forms.
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " JMT_WGMMA_D48
      ", %48, %49, p, 1, 1, %51, %52;\n"
      "}\n"
      : JMT_WGMMA_OUT48("+f")
      : "l"(a), "l"(b), "r"(1), "n"(int(TA)), "n"(int(TB)));
}

#undef JMT_WGMMA_D48
#undef JMT_WGMMA_OUT48

// The 32 accumulator registers of one m64n64 wgmma, as operands %0..%31.
#define JMT_WGMMA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64×64, f32) += op(A) (64×16) · op(B) (16×64), bf16: the dual mode's
// wgmma with an MN-major B (one 64-value swizzle atom wide).
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " JMT_WGMMA_D32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(int(TA)), "n"(int(TB)));
}

#undef JMT_WGMMA_D32

// The dual mode's wgmma at its tile width.
template <bool TA, bool TB, int ACC>
__device__ __forceinline__ void wgmma_dual(float (&d)[ACC], uint64_t a, uint64_t b) {
  if constexpr (ACC == 48)
    wgmma_96<TA, TB>(d, a, b);
  else
    wgmma_64<TA, TB>(d, a, b);
}

// Output tile `tile` of a walk over tiles W columns wide: entry z, first
// row m0, first column n0.
struct TilePos {
  int z, m0, n0;
};

template <int W>
__device__ __forceinline__ TilePos tile_pos(int tile, int tiles_m, int tiles_n) {
  const int per = tiles_m * tiles_n, r = tile % per;
  return {tile / per, r / tiles_n * BM, r % tiles_n * W};
}

// K steps of entry z (the last entry's K may be shorter). The producer and
// the consumers count alike, so neither waits for a step the other skips.
template <class T>
__device__ __forceinline__ int k_steps(int z, int nz, int K, int K_last) {
  constexpr int step = K_BYTES / (int)sizeof(T);
  const int kz = z == nz - 1 ? K_last : K;
  return (kz + step - 1) / step;
}

// One K step of an operand into the stage at dst, from the 2-D map `last`
// or the 3-D map `full` (entry z): K-major, one box of ROWS rows × 128
// bytes at (k0, r0); MN-major, ⌈ROWS/64⌉ boxes of 64 values × BK rows at
// (r0 + 64j, k0), MN_LBO bytes apart.
template <bool MN, int ROWS>
__device__ __forceinline__ void load_operand(unsigned char* dst, const CUtensorMap* full,
                                             const CUtensorMap* last, bool use_last, int z, int r0,
                                             int k0, uint64_t* bar) {
  const CUtensorMap* map = use_last ? last : full;
  if constexpr (MN) {
#pragma unroll
    for (int j = 0; j < (ROWS + 63) / 64; ++j)
      tma_load(dst + j * MN_LBO, map, r0 + 64 * j, k0, z, use_last, bar);
  } else {
    tma_load(dst, map, k0, r0, z, use_last, bar);
  }
}

// The chunked s8 mode's pieces: K cut into pieces of `chunk` codes; piece p
// of entry z is scaled by rs[z·row_batch + m·row_stride + p] and
// cs[z·col_batch + n] (chunk 0: not chunked).
struct Chunks {
  s8gemm::Scales sc;
  int chunk;
};

// The chunked mode's flush of one piece by one consumer thread, whose sums
// lie in rows m0, m0 + 8 and columns n0 + 8j + c (c < 2): run +=
// (f32(acc) · rs) · cs, each product and the sum rounded in f32 in
// gemm_s8.cuh's order, then acc = 0. Rows and columns past the edge take
// scale 0 (their sums are zero fill, and the epilogue skips them).
template <int ACC>
__device__ __forceinline__ void flush_piece(int (&acc)[ACC], float (&run)[ACC],
                                            const s8gemm::Scales& sc, long long z, int m0,
                                            int n0, int M, int N, int piece) {
  float rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 8 * i;
    rs[i] = m < M ? sc.row[z * sc.row_batch + (long long)m * sc.row_stride + piece] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + 8 * j + c;
      const float cs = n < N ? sc.col[z * sc.col_batch + n] : 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i + c;
        run[e] = __fadd_rn(run[e], __fmul_rn(__fmul_rn(static_cast<float>(acc[e]), rs[i]), cs));
        acc[e] = 0;
      }
    }
}

// The dual mode's epilogue without staging: the 8 columns of run 4g + q
// (q = lane % 4) of row r + 8i (r = lane / 4) of one product's sums d, out
// of the quad's accumulators (lane q holds columns 2q, 2q+1 of each run: a
// 4 × 4 transpose of pairs within the quad, by xor 2 then xor 1). o[2p + c]
// is the run's column 2p + c.
template <int ACC>
__device__ __forceinline__ void quad_run(const float (&d)[ACC], int g, int i, int q,
                                         float (&o)[8]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < 2; ++c) o[2 * jj + c] = d[4 * (4 * g + jj) + 2 * i + c];
  // slots 2h + b after the first exchange: the pair of lane bits (h, b') of
  // column bit b, where h is this lane's bit 1
  const bool hi = q & 2, odd = q & 1;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float recv = __shfl_xor_sync(0xffffffffu, hi ? o[2 * k + c] : o[4 + 2 * k + c], 2);
      if (hi)
        o[2 * k + c] = recv;
      else
        o[4 + 2 * k + c] = recv;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float recv =
          __shfl_xor_sync(0xffffffffu, odd ? o[4 * h + c] : o[4 * h + 2 + c], 1);
      if (odd)
        o[4 * h + c] = recv;
      else
        o[4 * h + 2 + c] = recv;
    }
}

// Images in group z of a sum over `images` images in groups of `per` (the
// last group may hold fewer). The producer and the consumers count alike.
__device__ __forceinline__ int group_images(int z, int per, int images) {
  const int left = images - z * per;
  return left < per ? left : per;
}

// K steps of one output tile: entry z's K steps (k_steps), or in the Group
// mode those of each image of group z.
template <class T, Mode MODE>
__device__ __forceinline__ int tile_k_steps(int z, int nz, int K, int K_last, int per,
                                            int images) {
  if constexpr (MODE == Mode::Group)
    return group_images(z, per, images) * k_steps<T>(0, 1, K, K);
  else
    return k_steps<T>(z, nz, K, K_last);
}

// The operands' tensor maps m0 .. m3 by mode: Plain and Chunked, A's full
// and last maps, then B's (operand_maps); Dual, A1, B1, A2, B2, each over
// every entry (entry_map); Group, A and B over every image (m2, m3 unused).
template <class T, bool TA, bool TB, Mode MODE, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap m0, const __grid_constant__ CUtensorMap m1,
            const __grid_constant__ CUtensorMap m2, const __grid_constant__ CUtensorMap m3,
            int nz, int a_batched, int b_batched, int M, int N, int K, int K_last, Chunks ch,
            int per, int images, Epi epi) {
  typedef typename Elem<T>::Acc Acc;
  constexpr bool CHUNKED = MODE == Mode::Chunked, DUAL = MODE == Mode::Dual;
  constexpr int W = TILE_W<MODE, TB>;
  typedef Tile<W, DUAL ? 2 : 1, TB> G;
  constexpr int NST = G::NSTAGES;
  constexpr int KI = Elem<T>::K_INST;
  constexpr int STEP = K_BYTES / (int)sizeof(T);
  static_assert(!CHUNKED || sizeof(T) == 1, "the chunked mode is the s8 core's");
  static_assert(!DUAL || sizeof(T) == 2, "the dual mode is the bf16 core's");
  static_assert(MODE != Mode::Group || (!TA && !TB), "the Group mode reads K-major operands");
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* staging = reinterpret_cast<float*>(smem + NST * G::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + G::STG_BYTES / 4);
  uint64_t* empty = full + NST;

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + W - 1) / W;
  const int tiles = nz * tiles_m * tiles_n;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], CONSUMERS * 4);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread walks this block's tiles and K steps, waiting for
    // each stage to come back empty before loading it again.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;  // K steps loaded so far, over all tiles: stage it % NST
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TilePos p = tile_pos<W>(tile, tiles_m, tiles_n);
        const int ktiles = tile_k_steps<T, MODE>(p.z, nz, K, K_last, per, images);
        const bool la = !a_batched || p.z == nz - 1, lb = !b_batched || p.z == nz - 1;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % NST;
          mbar_wait(&empty[s], ((it / NST) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(&full[s], G::STAGE_BYTES);
          unsigned char* st = smem + s * G::STAGE_BYTES;
          if constexpr (DUAL) {
            // both products' K step: A1, B1, then A2, B2 (entry p.z, or the
            // shared matrix through its 2-D map)
            const int za = a_batched ? p.z : 0, zb = b_batched ? p.z : 0;
            load_operand<TA, BM>(st, &m0, &m0, !a_batched, za, p.m0, kt * STEP, &full[s]);
            load_operand<TB, W>(st + A_BYTES, &m1, &m1, !b_batched, zb, p.n0, kt * STEP,
                                &full[s]);
            st += G::PAIR_BYTES;
            load_operand<TA, BM>(st, &m2, &m2, !a_batched, za, p.m0, kt * STEP, &full[s]);
            load_operand<TB, W>(st + A_BYTES, &m3, &m3, !b_batched, zb, p.n0, kt * STEP,
                                &full[s]);
          } else if constexpr (MODE == Mode::Group) {
            // step kt: K step kt % ks of image p.z·per + kt / ks
            const int ks = k_steps<T>(0, 1, K, K);
            const int img = p.z * per + kt / ks, k0 = kt % ks * STEP;
            load_operand<false, BM>(st, &m0, &m0, false, img, p.m0, k0, &full[s]);
            load_operand<false, W>(st + A_BYTES, &m1, &m1, false, img, p.n0, k0, &full[s]);
          } else {
            load_operand<TA, BM>(st, &m0, &m1, la, p.z, p.m0, kt * STEP, &full[s]);
            load_operand<TB, W>(st + A_BYTES, &m2, &m3, lb, p.z, p.n0, kt * STEP, &full[s]);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64c .. 64c+63 of each block tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    const int r = lane / 4, q = lane % 4;
    float* stg = staging + (c * 4 + warp) * STG_FLOATS;
    Acc acc[G::ACC];
    float run[CHUNKED ? G::ACC : 1];  // the chunked mode's f32 running sums
    float acc2[DUAL ? G::ACC : 1];    // the dual mode's second product
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const TilePos p = tile_pos<W>(tile, tiles_m, tiles_n);
      const int ktiles = tile_k_steps<T, MODE>(p.z, nz, K, K_last, per, images);
      const int mrow = p.m0 + c * 64 + warp * 16;  // this warp's first row
#pragma unroll
      for (int i = 0; i < G::ACC; ++i) acc[i] = 0;
      if constexpr (CHUNKED) {
#pragma unroll
        for (int i = 0; i < G::ACC; ++i) run[i] = 0.0f;
      }
      if constexpr (DUAL) {
#pragma unroll
        for (int i = 0; i < G::ACC; ++i) acc2[i] = 0.0f;
      }
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % NST;
        mbar_wait(&full[s], (it / NST) & 1);
        // this warpgroup's 64 rows: K-major 64 rows of 128 bytes, MN-major
        // box c (BK rows of 128 bytes); 8 KB either way
        const uint32_t a = smem_u32(smem + s * G::STAGE_BYTES) + c * (A_BYTES / CONSUMERS);
        const uint32_t b = smem_u32(smem + s * G::STAGE_BYTES + A_BYTES);
        fence_acc(acc);
        if constexpr (DUAL) fence_acc(acc2);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < STEP / KI; ++k) {
          const uint64_t da = desc_sw128(TA ? a + k * KI * K_BYTES : a + 32 * k, MN_LBO);
          const uint64_t db = desc_sw128(TB ? b + k * KI * K_BYTES : b + 32 * k, MN_LBO);
          if constexpr (CHUNKED) {
            wgmma_96<TA, TB>(acc, da, db);
            // a piece ends after this wgmma's K slice (which may be inside the
            // step): retire the wgmmas and flush the piece's sums
            const int kend = kt * STEP + (k + 1) * KI;
            if (kend % ch.chunk == 0 && kend <= K) {
              wgmma_commit();
              wgmma_wait<0>();
              fence_acc(acc);
              flush_piece(acc, run, ch.sc, p.z, mrow + r, p.n0 + 2 * q, M, N,
                          kend / ch.chunk - 1);
              fence_acc(acc);
              wgmma_fence();
            }
          } else if constexpr (DUAL) {
            // the second pair sits PAIR_BYTES further into the stage
            const uint32_t a2 = a + G::PAIR_BYTES, b2 = b + G::PAIR_BYTES;
            wgmma_dual<TA, TB>(acc, da, db);
            wgmma_dual<TA, TB>(acc2, desc_sw128(TA ? a2 + k * KI * K_BYTES : a2 + 32 * k, MN_LBO),
                               desc_sw128(TB ? b2 + k * KI * K_BYTES : b2 + 32 * k, MN_LBO));
          } else {
            wgmma_192<TA, TB>(acc, da, db);
          }
        }
        wgmma_commit();
        fence_acc(acc);
        if constexpr (DUAL) fence_acc(acc2);
        wgmma_wait<1>();  // the previous K step's wgmmas have retired: free its stage
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % NST]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if constexpr (DUAL) fence_acc(acc2);
      if (ktiles > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % NST]);

      if constexpr (DUAL) {
        // 32 columns at a time: lane (r, q) gathers run q of rows r and r + 8
        // of both products from its quad, then hands them to the functor
#pragma unroll
        for (int g = 0; g < W / 32; ++g)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v1[8], v2[8];
            quad_run(acc, g, i, q, v1);
            quad_run(acc2, g, i, q, v2);
            const int gm = mrow + r + 8 * i, gn = p.n0 + 32 * g + 8 * q;
            if (gm < M && gn < N) epi(p.z, gm, gn, v1, v2, min(8, N - gn));
          }
      } else {
        // Epilogue: 32 columns at a time through the warp's staging tile; lane
        // (r, q) of the accumulator writes its pairs, then 4 lanes a row read
        // 8 columns each. The chunked mode hands over its running sums.
        auto val = [&](int e) {
          if constexpr (CHUNKED)
            return run[e];
          else
            return static_cast<float>(acc[e]);
        };
#pragma unroll
        for (int cc = 0; cc < W / 32; ++cc) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = cc * 4 + jj, col = jj * 8 + 2 * q;
            *reinterpret_cast<float2*>(stg + r * STG_LD + col) =
                make_float2(val(4 * j), val(4 * j + 1));
            *reinterpret_cast<float2*>(stg + (r + 8) * STG_LD + col) =
                make_float2(val(4 * j + 2), val(4 * j + 3));
          }
          __syncwarp();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            const int gm = mrow + row, gn = p.n0 + cc * 32 + q * 8;
            if (gm < M && gn < N)
              epi(p.z, gm, gn, stg + row * STG_LD + q * 8, min(8, N - gn));
          }
          __syncwarp();
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (null if it is
// not there).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// One operand of a product: element (row, col) of entry z at
// p + z·zstride + row·ld + col (zstride 0: shared by every entry).
struct Operand {
  const void* p;
  int ld;
  long long zstride;
};

// Whether TMA can load the operand's entries: base 16-byte aligned, row
// and entry strides multiples of 16 bytes.
template <class T>
inline bool tma_ok(const Operand& o) {
  return reinterpret_cast<uintptr_t>(o.p) % 16 == 0 && (o.ld * sizeof(T)) % 16 == 0 &&
         (o.zstride * (long long)sizeof(T)) % 16 == 0;
}

// The maps of one operand whose M (or N) extent is `mn` (box_rows rows a
// K-major box): `last`, 2-D (columns, rows), of entry nz−1 with K_last;
// `full`, 3-D (columns, rows, entries), of entries 0 .. nz−2 with K (a
// copy of `last` where the operand is not batched). 128-byte swizzled,
// zero past the edges.
template <class T, bool MN>
inline bool operand_maps(CUtensorMap* full, CUtensorMap* last, const Operand& o, int mn,
                         int box_rows, int nz, int K, int K_last) {
  const auto encode = tensor_map_encoder();
  if (!encode) return false;
  constexpr long long es = sizeof(T);
  const cuuint64_t strides[2] = {(cuuint64_t)(o.ld * es), (cuuint64_t)(o.zstride * es)};
  const cuuint32_t box[3] = {MN ? 64u : (cuuint32_t)(K_BYTES / es),
                             MN ? (cuuint32_t)BK : (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[3] = {1, 1, 1};
  cuuint64_t dims[3] = {(cuuint64_t)(MN ? mn : K_last), (cuuint64_t)(MN ? K_last : mn),
                        (cuuint64_t)(nz - 1)};
  const char* base = static_cast<const char*>(o.p) + (long long)(nz - 1) * o.zstride * es;
  if (encode(last, Elem<T>::tma_type(), 2, const_cast<char*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (nz == 1 || o.zstride == 0) {
    *full = *last;
    return true;
  }
  dims[MN ? 1 : 0] = (cuuint64_t)K;
  return encode(full, Elem<T>::tma_type(), 3, const_cast<void*>(o.p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

#define SM90_TRY(call)                  \
  do {                                  \
    const cudaError_t e_ = (call);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

// A map over every entry of an operand (the Dual and Group modes, where
// every entry has the same K): 3-D (columns, rows, entries) where it is
// batched, 2-D where it is shared (zstride 0). Loads read entry z of a 3-D
// map, so a box never straddles two entries and an entry's K tail and
// rows past mn read zeros.
template <class T, bool MN>
inline bool entry_map(CUtensorMap* map, const Operand& o, int mn, int box_rows, int entries,
                      int K) {
  const auto encode = tensor_map_encoder();
  if (!encode) return false;
  constexpr long long es = sizeof(T);
  const cuuint64_t strides[2] = {(cuuint64_t)(o.ld * es), (cuuint64_t)(o.zstride * es)};
  const cuuint32_t box[3] = {MN ? 64u : (cuuint32_t)(K_BYTES / es),
                             MN ? (cuuint32_t)BK : (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[3] = {1, 1, 1};
  const cuuint64_t dims[3] = {(cuuint64_t)(MN ? mn : K), (cuuint64_t)(MN ? K : mn),
                              (cuuint64_t)entries};
  return encode(map, Elem<T>::tma_type(), o.zstride ? 3 : 2, const_cast<void*>(o.p), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the kernel of a mode on its maps: persistent blocks, one per SM
// (at most one per tile); counts the launch per mode.
template <class T, bool TA, bool TB, Mode MODE, class Epi>
cudaError_t run_kernel(cudaStream_t stream, const CUtensorMap (&maps)[4], int nz, bool a_batched,
                       bool b_batched, int M, int N, int K, int K_last, const Chunks& ch, int per,
                       int images, const Epi& epi) {
  constexpr int W = TILE_W<MODE, TB>;
  const auto kernel = gemm_kernel<T, TA, TB, MODE, Epi>;
  // setmaxnreg moves registers between warpgroups within the block's own
  // allocation: refuse to launch (rather than hang) if ptxas gave it less.
  cudaFuncAttributes attr;
  SM90_TRY(cudaFuncGetAttributes(&attr, kernel));
  if (attr.numRegs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS)
    return cudaErrorInvalidConfiguration;
  constexpr int smem = Tile<W, MODE == Mode::Dual ? 2 : 1, TB>::SMEM_BYTES;
  SM90_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  int dev = 0, sms = 0;
  SM90_TRY(cudaGetDevice(&dev));
  SM90_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const long long tiles = (long long)nz * ((M + BM - 1) / BM) * ((N + W - 1) / W);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], nz, a_batched,
                                          b_batched, M, N, K, K_last, ch, per, images, epi);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_modes[static_cast<int>(MODE)];
  return e;
}

// The wgmma core alone: cudaErrorInvalidValue where TMA's rules do not hold
// or the shapes are not a product's. CHUNKED: the chunked s8 mode, its
// pieces in `ch`.
template <class T, bool TA, bool TB, bool CHUNKED = false, class Epi>
cudaError_t launch_sm90(cudaStream_t stream, int nz, int M, int N, int K, int K_last,
                        const Operand& a, const Operand& b, const Epi& epi,
                        const Chunks& ch = Chunks{}) {
  constexpr Mode MODE = CHUNKED ? Mode::Chunked : Mode::Plain;
  if (nz <= 0 || M <= 0 || N <= 0 || K <= 0 || K_last <= 0 || K_last > K || !tma_ok<T>(a) ||
      !tma_ok<T>(b))
    return cudaErrorInvalidValue;
  if ((a.zstride == 0 || b.zstride == 0) && K_last != K)  // a shared matrix has one K
    return cudaErrorInvalidValue;
  if (CHUNKED && (ch.chunk <= 0 || ch.chunk % Elem<T>::K_INST || K % ch.chunk || K_last != K))
    return cudaErrorInvalidValue;  // pieces end on a wgmma's K slice and tile every entry's K
  CUtensorMap maps[4];
  if (!operand_maps<T, TA>(&maps[0], &maps[1], a, M, BM, nz, K, K_last) ||
      !operand_maps<T, TB>(&maps[2], &maps[3], b, N, TILE_W<MODE, TB>, nz, K, K_last))
    return cudaErrorInvalidValue;
  const cudaError_t e = run_kernel<T, TA, TB, MODE>(stream, maps, nz, a.zstride != 0,
                                                    b.zstride != 0, M, N, K, K_last, ch, 0, 0,
                                                    epi);
  if (e == cudaSuccess) ++g_products[Elem<T>::WGMMA];
  return e;
}

// C[(z·M + m)·N + n] = v in f32: entries one after another, rows N apart.
struct StoreEntries {
  float* C;
  int M, N;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    float* o = C + (z * M + m) * (long long)N + n;
    if (cnt == 8 && aligned16(o)) {
      store8(o, v);
    } else {
      for (int e = 0; e < cnt; ++e) o[e] = v[e];
    }
  }

  __device__ void row8(long long z, int m, int n, const float* v) const { (*this)(z, m, n, v, 8); }
};

// The dual mode's second product on the WMMA core: v1 from the f32 the
// first product stored (StoreEntries' layout), v2 its own sums.
template <class Epi>
struct SecondOfDual {
  const float* V1;
  int M, N;
  Epi epi;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const float* p = V1 + (z * M + m) * (long long)N + n;
    float v1[8];
    for (int e = 0; e < cnt; ++e) v1[e] = p[e];
    epi(z, m, n, v1, v, cnt);
  }
};

// bf16, two products of one tile: C[z] = epi(z, m, n, v1, v2, cnt) with
// v1 = op(A1[z])·op(B1[z]) and v2 = op(A2[z])·op(B2[z]), f32 sums of row m,
// columns n .. n+cnt−1 (n % 8 == 0, cnt ≤ 8), for z < nz. Both products
// share M, N, K (every entry's), TA and TB, and which operands are batched
// (zstride ≠ 0). On the wgmma core's dual mode (192×96 tiles, 192×64 with
// an MN-major B) where TMA can load all four operands; else (or with
// Core::Legacy) on the WMMA core as two products, v1 through `scratch`
// (nz·M·N f32, StoreEntries' layout; cudaErrorInvalidValue without it).
// Counted as two products on the route taken.
template <bool TA, bool TB, class Epi>
cudaError_t gemm_bf16_dual(cudaStream_t stream, int nz, int M, int N, int K, const Operand& a1,
                           const Operand& b1, const Operand& a2, const Operand& b2,
                           const Epi& epi, float* scratch, Core core = Core::Auto) {
  if (nz <= 0 || M <= 0 || N <= 0 || K <= 0 || (a1.zstride != 0) != (a2.zstride != 0) ||
      (b1.zstride != 0) != (b2.zstride != 0))
    return cudaErrorInvalidValue;
  const bool tma = tma_ok<bf16>(a1) && tma_ok<bf16>(b1) && tma_ok<bf16>(a2) && tma_ok<bf16>(b2);
  if (core == Core::Sm90 || (core == Core::Auto && tma)) {
    if (!tma) return cudaErrorInvalidValue;
    constexpr int W = TILE_W<Mode::Dual, TB>;
    CUtensorMap maps[4];
    if (!entry_map<bf16, TA>(&maps[0], a1, M, BM, nz, K) ||
        !entry_map<bf16, TB>(&maps[1], b1, N, W, nz, K) ||
        !entry_map<bf16, TA>(&maps[2], a2, M, BM, nz, K) ||
        !entry_map<bf16, TB>(&maps[3], b2, N, W, nz, K))
      return cudaErrorInvalidValue;
    const cudaError_t e = run_kernel<bf16, TA, TB, Mode::Dual>(
        stream, maps, nz, a1.zstride != 0, b1.zstride != 0, M, N, K, K, Chunks{}, 0, 0, epi);
    if (e == cudaSuccess) g_products[SM90] += 2;
    return e;
  }
  if (!scratch) return cudaErrorInvalidValue;
  SM90_TRY((bf16gemm::gemm_ex<TA, !TB>(stream, nz, M, N, K, a1.p, a1.ld, a1.zstride, b1.p, b1.ld,
                                       b1.zstride, StoreEntries{scratch, M, N})));
  const cudaError_t e =
      bf16gemm::gemm_ex<TA, !TB>(stream, nz, M, N, K, a2.p, a2.ld, a2.zstride, b2.p, b2.ld,
                                 b2.zstride, SecondOfDual<Epi>{scratch, M, N, epi});
  if (e == cudaSuccess) g_products[WMMA] += 2;
  return e;
}

// Images per group of a sum over `images` images with an M×N output on the
// wgmma core: whole images, about sms / tiles groups for the output's
// 192×192 tiles, so that the (group, tile) pairs fill the card about once;
// at least one group, at most one an image.
inline int images_per_group(int images, int M, int N, int sms) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int g = std::max(1, std::min(images, sms / tiles));
  return (images + g - 1) / g;
}

// bf16, a sum over images in groups: C[g] = epi(g, Σ_b A_b · B_bᵀ) over the
// images b = g·per .. of group g (the last group may hold fewer), A_b (M×K)
// and B_b (N×K) K-major, image b at A + b·sA and B + b·sB (both batched).
// On the wgmma core's Group mode (each tile's K loop walks its group's
// images and their K steps through the operands' 3-D maps) where TMA can
// load both; else (or with Core::Legacy) on the WMMA core's gemm_sum. One
// f32 partial a group, added by the caller in a fixed order: no atomics.
template <class Epi>
cudaError_t gemm_bf16_grouped(cudaStream_t stream, int images, int per, int M, int N, int K,
                              const void* A, int lda, long long sA, const void* B, int ldb,
                              long long sB, const Epi& epi, Core core = Core::Auto) {
  const Operand a{A, lda, sA}, b{B, ldb, sB};
  if (images <= 0 || per <= 0 || M <= 0 || N <= 0 || K <= 0 || sA == 0 || sB == 0)
    return cudaErrorInvalidValue;
  const int groups = (images + per - 1) / per;
  const bool tma = tma_ok<bf16>(a) && tma_ok<bf16>(b);
  if (core == Core::Sm90 || (core == Core::Auto && tma)) {
    CUtensorMap maps[4];
    if (!tma || !entry_map<bf16, false>(&maps[0], a, M, BM, images, K) ||
        !entry_map<bf16, false>(&maps[1], b, N, BN, images, K))
      return cudaErrorInvalidValue;
    maps[2] = maps[0];
    maps[3] = maps[1];
    const cudaError_t e = run_kernel<bf16, false, false, Mode::Group>(
        stream, maps, groups, true, true, M, N, K, K, Chunks{}, per, images, epi);
    if (e == cudaSuccess) ++g_products[SM90];
    return e;
  }
  const cudaError_t e = bf16gemm::gemm_sum<false, true>(stream, (long long)images * K, K, per, M,
                                                        N, A, lda, sA, B, ldb, sB, epi);
  if (e == cudaSuccess) ++g_products[WMMA];
  return e;
}

// bf16: C[z] = epi(z, op(A[z])·op(B[z])) for z < nz (see the header; A
// entries sA elements apart, B entries sB apart), on the wgmma core where
// TMA's rules hold (Core::Auto), else on the WMMA core with the same entries
// (gemm_bf16.cuh: A_T is an MN-major A, B_T a K-major B; several entries
// are gemm_sum's images, one a block).
template <bool TA, bool TB, class Epi>
cudaError_t gemm_bf16(cudaStream_t stream, int nz, int M, int N, int K, int K_last,
                      const void* A, int lda, long long sA, const void* B, int ldb,
                      long long sB, const Epi& epi, Core core = Core::Auto) {
  const Operand a{A, lda, sA}, b{B, ldb, sB};
  if (core == Core::Sm90 || (core == Core::Auto && tma_ok<bf16>(a) && tma_ok<bf16>(b)))
    return launch_sm90<bf16, TA, TB>(stream, nz, M, N, K, K_last, a, b, epi);
  const cudaError_t e =
      nz == 1 ? bf16gemm::gemm_ex<TA, !TB>(stream, 1, M, N, K_last, A, lda, 0, B, ldb, 0, epi)
              : bf16gemm::gemm_sum<TA, !TB>(stream, (long long)(nz - 1) * K + K_last, K, 1, M,
                                            N, A, lda, sA, B, ldb, sB, epi);
  if (e == cudaSuccess) ++g_products[WMMA];
  return e;
}

// C = epi(A · Bᵀ), A (M×K) and B (N×K) row-major bf16: one product, K-major
// operands (the Mixer channel products).
template <class Epi>
cudaError_t gemm_tn(cudaStream_t stream, int M, int N, int K, const void* A, int lda, const void* B,
                    int ldb, const Epi& epi, Core core = Core::Auto) {
  return gemm_bf16<false, false>(stream, 1, M, N, K, K, A, lda, 0, B, ldb, 0, epi, core);
}

// The s8 core's epilogue: v = (f32(acc) · rs[m]) · cs[n], gemm_s8.cuh's
// dequantization of one K chunk, then the W8A8 functor.
template <class Epi>
struct Dequant {
  s8gemm::Scales sc;
  Epi epi;

  __device__ void operator()(long long z, int m, int n, const float* acc, int cnt) const {
    const float rs = sc.row[z * sc.row_batch + (long long)m * sc.row_stride];
    const float* cs = sc.col + z * sc.col_batch + n;
    float v[8];
    for (int e = 0; e < cnt; ++e) v[e] = __fmul_rn(__fmul_rn(acc[e], rs), cs[e]);
    if (cnt == 8) {
      epi.row8(z, m, n, v);
    } else {
      epi(z, m, n, v, cnt);
    }
  }
};

// int8: C[z] = epi(z, m, n, (f32(A[z]·B[z]ᵀ) · rs) · cs), A[z] M×K and
// B[z] N×K row-major int8 (entries sA, sB elements apart), K a multiple of
// 32 (zero codes past the data), one K chunk; on the s8 wgmma core
// (Core::Auto, Core::Sm90), or on gemm_s8.cuh's mma.sync core
// (Core::Legacy). Both refuse rows that are not 16-byte aligned.
template <class Epi>
cudaError_t gemm_s8(cudaStream_t stream, int nz, int M, int N, int K, const void* A, int lda,
                    long long sA, const void* B, int ldb, long long sB, const s8gemm::Scales& sc,
                    const Epi& epi, Core core = Core::Auto) {
  if (K % 32) return cudaErrorInvalidValue;
  if (core != Core::Legacy)
    return launch_sm90<int8_t, false, false>(stream, nz, M, N, K, K, Operand{A, lda, sA},
                                             Operand{B, ldb, sB}, Dequant<Epi>{sc, epi});
  const cudaError_t e = s8gemm::gemm(stream, nz, M, N, K, K, A, lda, sA, B, ldb, sB, sc, epi);
  if (e == cudaSuccess) ++g_products[MMA_S8];
  return e;
}

// The chunked s8 mode's epilogue: v, the running sums, is dequantized
// already and goes to the W8A8 functor unchanged (eight columns through its
// row8, as Dequant hands them).
template <class Epi>
struct Rows8 {
  Epi epi;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    if (cnt == 8) {
      epi.row8(z, m, n, v);
    } else {
      epi(z, m, n, v, cnt);
    }
  }
};

// int8 with K in pieces: C[z] = epi(z, m, n, v), v = Σ_p (f32(A[z]·B[z]ᵀ
// over piece p) · rs[.., m, p]) · cs[n] summed in piece order from 0
// (gemm_s8.cuh's chunk flush; sc.row_stride is the pieces a row), pieces of
// `chunk` codes, a multiple of 32 that divides K. On the s8 wgmma core's
// chunked mode (Core::Auto, Core::Sm90: 192×96 tiles, the flush after the
// wgmma whose K slice ends a piece), or on gemm_s8.cuh's mma.sync core
// (Core::Legacy).
template <class Epi>
cudaError_t gemm_s8_chunked(cudaStream_t stream, int nz, int M, int N, int K, int chunk,
                            const void* A, int lda, long long sA, const void* B, int ldb,
                            long long sB, const s8gemm::Scales& sc, const Epi& epi,
                            Core core = Core::Auto) {
  if (core != Core::Legacy)  // each core refuses pieces that do not tile K in 32-code slices
    return launch_sm90<int8_t, false, false, true>(stream, nz, M, N, K, K, Operand{A, lda, sA},
                                                   Operand{B, ldb, sB}, Rows8<Epi>{epi},
                                                   Chunks{sc, chunk});
  const cudaError_t e =
      s8gemm::gemm(stream, nz, M, N, K, chunk, A, lda, sA, B, ldb, sB, sc, epi);
  if (e == cudaSuccess) ++g_products[MMA_S8];
  return e;
}

#undef SM90_TRY

}  // namespace sm90
}  // namespace jmt
