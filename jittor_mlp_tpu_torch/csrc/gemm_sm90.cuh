// A Hopper GEMM core (sm_90a) for the Mixer block's channel products:
//
//   C = epi(A · Bᵀ),   A (M×K) row-major at leading dimension lda,
//                      B (N×K) row-major at ldb (a torch Linear weight),
//
// bf16 operands, f32 sums, one product (the weight shared by every row).
// The epilogue is gemm_bf16.cuh's functor, unchanged:
//   void operator()(long long z, int m, int n, const float* v, int cnt) const
// gets the f32 sums of row m, columns n .. n+cnt-1 (n % 8 == 0, cnt ≤ 8),
// with z = 0. So GeluBias, ResidualBias and the kernel lab's epilogues
// (lab_block.cuh) plug in as they are, and every rounding point of a block
// stays where it was.
//
// Which TPU work it serves: the channel half of
// jittor_mlp_tpu/ops/pallas/mixer_block.py:157 fused_mixer_block (kernel 1,
// mixer_block.cu) and of its forward-with-h (mixer_block_bwd.cu), through
// mixer_forward.cuh; the kernel lab's bodies call it for the same products.
//
// What bounds it: at Mixer-B/16 b256 each channel product is M = 50,176
// rows, K 768 → N 3072 or K 3072 → N 768: 236.8 GFLOP, 0.239 ms at the
// H100's 989 TFLOP/s dense bf16 peak, against 0.1–0.4 GB of operands and
// output (≤ 0.12 ms at 3.35 TB/s): bound by operations. Only wgmma reaches
// that rate; the WMMA core (gemm_bf16.cuh) ran these products at ≈ 160.
// What the design does about it:
// - Loads: TMA (cp.async.bulk.tensor.2d, the CUtensorMap a __grid_constant__
//   parameter) of 192×64 A and 192×64 B tiles into 128-byte-swizzled shared
//   memory aligned to 1024 bytes, the layout wgmma reads through its
//   descriptors. Ragged M, N and K tails are TMA's out-of-bounds zero fill:
//   the main loop has no masks, and the epilogue skips rows ≥ M and columns
//   ≥ N.
// - Pipeline: a ring of STAGES = 4 stages (48 KB each) with full and empty
//   mbarriers. One producer thread (warpgroup 0, which gives up registers
//   with setmaxnreg) keeps the TMA loads in flight; three consumer
//   warpgroups each issue wgmma.m64n192k16 on their 64 rows of the 192×192
//   block tile, four per 64-wide K step, and keep one step's wgmmas in
//   flight: a stage goes back to the producer only after the wgmmas that
//   read it have retired (wait_group 1, then an arrive on its empty
//   barrier from each consumer warp).
// - The tile: the L2 feeds 48 KB a K step for 4.7 MFLOP (98 FLOP a byte;
//   128×256 with two consumers measured slower on the card, at 85), and
//   the consumers' 96 f32 accumulators a thread fit the 128 registers that
//   four warpgroups leave (m64n256 needs 154: three of those do not fit).
// - Persistent blocks, one per SM (the ring and staging take 220 KB of
//   shared memory), walk the output tiles in row-major order with a stride
//   of the grid, so the producer loads the next tile while the consumers
//   run this one's epilogue, and the ≈ 132 tiles in flight share their A
//   rows; the 4.7 MB weight stays in the 50 MB L2.
// - Epilogue: wgmma's accumulator spreads a row's 8 columns over the 4
//   lanes of a quad, so each consumer warp stages its 16 rows 32 columns at
//   a time through 2.3 KB of shared memory, and 4 lanes then hand one
//   row's 32 columns (64 contiguous bytes of bf16 output) to the functor.
//   The epilogue does not overlap this block's wgmmas: with a GELU (its
//   tanhf) it is what keeps the K = 768 product furthest from the peak.
// - Deterministic: no split-K and no atomics. Each output element is one
//   tile's sum over K in a fixed order, whatever the grid: two calls agree
//   bit for bit, and so do two callers with the same rows (the kernel lab's
//   bodies and kernel 1).
//
// Two routes, both hand-written and both counted (products(route)):
// gemm_tn takes this core where TMA's rules hold (A and B 16-byte aligned,
// lda and ldb multiples of 8 elements, i.e. 16-byte row strides); otherwise
// it runs bf16gemm::gemm<true> (the WMMA core) on the same arguments.
// cuTensorMapEncodeTiled is looked up in libcuda at run time (the runtime's
// entry-point query), so the library needs no -lcuda.
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000

#include <atomic>

#include "gemm_bf16.cuh"

namespace jmt {
namespace sm90 {

constexpr int CONSUMERS = 3;                      // warpgroups of 64 tile rows each
constexpr int BM = 64 * CONSUMERS, BN = 192, BK = 64;  // block tile; BK bf16: one 128-byte row
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (1 + CONSUMERS);    // warpgroup 0 produces
// setmaxnreg: 128·40 + 384·152 = 63,488 of the 512·128 the launch bounds give
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 152;
constexpr int A_BYTES = BM * BK * 2;              // 24 KB
constexpr int B_BYTES = BN * BK * 2;              // 24 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STG_LD = 36;                        // f32 row of a warp's 16×32 staging tile
constexpr int STG_FLOATS = 16 * STG_LD;
static_assert(BN == 192, "the consumers' wgmma is m64n192k16");
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + CONSUMERS * 4 * STG_FLOATS * 4 +
                           2 * STAGES * 8;        // alignment slack, ring, staging, barriers
static_assert(SMEM_BYTES <= 232448, "the ring fits the 227 KB a block may use");

enum Route { SM90 = 0, WMMA = 1 };
enum class Core { Auto = 0, Sm90 = 1, Wmma = 2 };

// Products launched per route, in this library (internal linkage: each
// kernel library is one translation unit and keeps its own counts).
static std::atomic<long long> g_products[2];

inline long long products(int route) {
  return route == SM90 || route == WMMA ? g_products[route].load() : -1;
}

// Whether TMA can load a row-major bf16 operand at p with leading dimension ld.
inline bool tma_ok(const void* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

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

// One box of a 2-D tensor map (x: column, y: row) into shared memory; the
// bytes land on `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: start address,
// leading byte offset 16 (unused by this layout), stride 1024 bytes between
// 8-row groups, layout type 1 (128B swizzle). The tile is 1024-aligned;
// +32 bytes of start address is the next 16-wide K slice.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
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

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma and its wait.
__device__ __forceinline__ void fence_acc(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64×192, f32) += A (64×16, K-major, desc a) · B (192×16, K-major, desc b)ᵀ
// for one warpgroup. d[4j + 2i + c] holds row 16·warp + lane/4 + 8i, column
// 8j + 2·(lane % 4) + c.
__device__ __forceinline__ void wgmma_192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               int M, int N, int K, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* staging = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + CONSUMERS * 4 * STG_FLOATS);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int ktiles = (K + BK - 1) / BK;  // the last K step is zero-filled past K
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      int it = 0;  // K steps loaded so far, over all tiles: stage it % STAGES
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(&full[s], STAGE_BYTES);
          unsigned char* st = smem + s * STAGE_BYTES;
          tma_load(st, &map_a, kt * BK, m0, &full[s]);
          tma_load(st + A_BYTES, &map_b, kt * BK, n0, &full[s]);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64c .. 64c+63 of each block tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    float* stg = staging + (c * 4 + warp) * STG_FLOATS;
    float acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + c * 64 * 128;  // 64 rows of 128 B
        const uint32_t b = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_192(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous K step's wgmmas have retired: free its stage
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (ktiles > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // Epilogue: 32 columns at a time through the warp's staging tile; lane
      // (r, q) of the accumulator writes its pairs, then 4 lanes a row read
      // 8 columns each.
      const int mrow = m0 + c * 64 + warp * 16;  // this warp's first row
      const int r = lane / 4, q = lane % 4;
#pragma unroll
      for (int cc = 0; cc < BN / 32; ++cc) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = cc * 4 + jj, col = jj * 8 + 2 * q;
          *reinterpret_cast<float2*>(stg + r * STG_LD + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(stg + (r + 8) * STG_LD + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          const int gm = mrow + row, gn = n0 + cc * 32 + q * 8;
          if (gm < M && gn < N) epi(0, gm, gn, stg + row * STG_LD + q * 8, min(8, N - gn));
        }
        __syncwarp();
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

// A 2-D map of a rows × cols bf16 row-major matrix (leading dimension ld),
// read in boxes of box_rows × BK, 128-byte swizzled, zero past the edges.
inline bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int ld, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

#define SM90_TRY(call)                  \
  do {                                  \
    const cudaError_t e_ = (call);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

// This core alone: cudaErrorInvalidValue where TMA's rules do not hold.
template <class Epi>
cudaError_t gemm_tn_sm90(cudaStream_t stream, int M, int N, int K, const void* A, int lda,
                         const void* B, int ldb, const Epi& epi) {
  if (M <= 0 || N <= 0 || K <= 0 || !tma_ok(A, lda) || !tma_ok(B, ldb))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, A, M, K, lda, BM) || !tensor_map(&map_b, B, N, K, ldb, BN))
    return cudaErrorInvalidValue;
  const auto kernel = gemm_tn_kernel<Epi>;
  // setmaxnreg moves registers between warpgroups within the block's own
  // allocation: refuse to launch (rather than hang) if ptxas gave it less.
  cudaFuncAttributes attr;
  SM90_TRY(cudaFuncGetAttributes(&attr, kernel));
  if (attr.numRegs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS)
    return cudaErrorInvalidConfiguration;
  SM90_TRY(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
  int dev = 0, sms = 0;
  SM90_TRY(cudaGetDevice(&dev));
  SM90_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, M, N, K, epi);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_products[SM90];
  return e;
}

// C = epi(A · Bᵀ) on this core where TMA's rules hold, else on the WMMA
// core (Core::Auto); Core::Sm90 and Core::Wmma force one (Sm90 then fails
// where the rules do not hold).
template <class Epi>
cudaError_t gemm_tn(cudaStream_t stream, int M, int N, int K, const void* A, int lda, const void* B,
                    int ldb, const Epi& epi, Core core = Core::Auto) {
  const bool tma = tma_ok(A, lda) && tma_ok(B, ldb);
  if (core == Core::Sm90 || (core == Core::Auto && tma))
    return gemm_tn_sm90(stream, M, N, K, A, lda, B, ldb, epi);
  const cudaError_t e = bf16gemm::gemm<true>(stream, 1, M, N, K, A, lda, 0, B, ldb, 0, epi);
  if (e == cudaSuccess) ++g_products[WMMA];
  return e;
}

#undef SM90_TRY

}  // namespace sm90
}  // namespace jmt
