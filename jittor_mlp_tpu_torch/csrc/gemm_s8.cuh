// Batched int8 × int8 → int32 GEMM on the tensor cores (mma.sync m16n8k32),
// with f32 dequantization and a pluggable epilogue. The W8A8 blocks ran
// their products on it before the s8 wgmma core (gemm_sm90.cuh) took them;
// it stays as that core's comparison core (Core::Legacy).
//
//   acc[z] (M×N) = A[z] (M×K) · B[z]ᵀ         A: M×K, B: N×K, both row-major
//                                             int8, K-contiguous
//   v = Σ_chunks (f32(acc_chunk) · rs[z, m, chunk]) · cs[z, n]
//   epi(z, m, n, v)
//
// mma.sync's s8 shapes take A row-major and B column-major only, so both
// operands are K-contiguous; the callers' quantize passes write them so. K
// is padded with zeros to a multiple of 32 (the MMA's K) and rows are 16-byte
// aligned, which the host side checks.
//
// Chunks: the K axis is cut into pieces of `chunk` (a multiple of 32 that
// divides K; chunk = K for one piece). The int32 sum of each piece is
// flushed into the f32 sum v at the piece's end, times its own row scale,
// in order: v = 0 + p0 + p1 + … — the W8A8 channel mix's per-(row, chunk)
// activation scales. With one piece, v = f32(acc) · rs[m] · cs[n].
// int32 cannot overflow: |acc| ≤ 127²·K, under 2³¹ for K < 133,000.
//
// 128×128 output tiles, 8 warps of 64×32, K steps of 64 bytes in a
// two-stage cp.async ring; shared-memory rows are padded to 80 bytes, so
// the warps' 32-bit fragment loads hit 32 distinct banks.
#pragma once

#include "common.cuh"

namespace jmt {
namespace s8gemm {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;       // 8 warps: 2 along M, 4 along N
constexpr int WM = 64, WN = 32;    // one warp's output tile
constexpr int FM = WM / 16;        // m16 fragments per warp
constexpr int FN = WN / 8;         // n8 fragments per warp
constexpr int LDS = BK + 16;       // bytes per shared-memory row

// Row scale rs[z·row_batch + m·row_stride + chunk]; column scale
// cs[z·col_batch + n].
struct Scales {
  const float* row;
  long long row_batch;
  int row_stride;
  const float* col;
  long long col_batch;
};

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [r0, r0+128) × bytes [k0, k0+64) of a row-major int8 matrix
// (rows < rows valid, K bytes per row valid, leading dimension ld) into
// shared memory; what lies outside is zero-filled.
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g, int ld, int r0,
                                          int rows, int k0, int K) {
  for (int i = threadIdx.x; i < BM * (BK / 16); i += THREADS) {
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const bool ok = r0 + r < rows && k0 + c < K;
    cp_async16(s + r * LDS + c, ok ? g + (size_t)(r0 + r) * ld + k0 + c : g, ok ? 16 : 0);
  }
}

// The epilogue is a functor
//   void operator()(long long z, int m, int n, const float* v, int cnt) const
// receiving row m, columns n .. n+cnt-1 (cnt ≤ 2, n even).
template <class Epi>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(int M, int N, int K, int chunk, const int8_t* __restrict__ A, int lda,
            long long sA, const int8_t* __restrict__ B, int ldb, long long sB, Scales sc,
            Epi epi) {
  constexpr int STAGE = (BM + BN) * LDS;
  __shared__ __align__(128) int8_t smem[2 * STAGE];

  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += z * sA;
  B += z * sB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;  // mma fragment group and thread-in-group

  int acc[FM][FN][4];
  float facc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0, facc[i][j][e] = 0.0f;

  // Fragment element e of (i, j) lies at row wm·64 + i·16 + g + 8·(e/2),
  // column wn·32 + j·8 + 2t + e%2 of the tile.
  auto flush = [&](int piece) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + i * 16 + g + 8 * h;
        const float rs =
            m < M ? sc.row[z * sc.row_batch + (long long)m * sc.row_stride + piece] : 0.0f;
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * WN + j * 8 + 2 * t + e;
            const float cs = n < N ? sc.col[z * sc.col_batch + n] : 0.0f;
            // (acc·rs)·cs, then the sum: rounded as the reference rounds
            // it, with no fused multiply-add
            const float p = __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), rs), cs);
            facc[i][j][2 * h + e] = __fadd_rn(facc[i][j][2 * h + e], p);
            acc[i][j][2 * h + e] = 0;
          }
      }
  };

  auto load_stage = [&](int stage, int k0) {
    int8_t* As = smem + stage * STAGE;
    load_tile(As, A, lda, m0, M, k0, K);
    load_tile(As + BM * LDS, B, ldb, n0, N, k0, K);
  };

  const int KT = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int8_t* As = smem + (kt & 1) * STAGE;
    const int8_t* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int kend = kt * BK + kk + 32;
      if (kend > K) break;  // K is a multiple of 32: only a whole step can be past it
      int a[FM][4], b[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int8_t* p = As + (wm * WM + i * 16 + g) * LDS + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const int*>(p);
        a[i][1] = *reinterpret_cast<const int*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const int*>(p + 16);
        a[i][3] = *reinterpret_cast<const int*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int8_t* p = Bs + (wn * WN + j * 8 + g) * LDS + kk + 4 * t;
        b[j][0] = *reinterpret_cast<const int*>(p);
        b[j][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], a[i], b[j]);
      if (kend % chunk == 0) flush(kend / chunk - 1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * t;
        if (n < N) epi(z, m, n, &facc[i][j][2 * h], min(2, N - n));
      }
    }
}

// Epilogue: C = gelu_tanh(v + bias) in f32; bias per row of C or per
// column. row8: eight columns of the s8 wgmma core's epilogue
// (gemm_sm90.cuh), the same arithmetic, as two 16-byte stores where C is
// aligned.
struct BiasGeluF32 {
  const bf16* bias;
  int per_row;
  float* C;
  int ldc;
  long long sC;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    float* c = C + z * sC + (long long)m * ldc + n;
    for (int e = 0; e < cnt; ++e)
      c[e] = gelu_tanh(__fadd_rn(v[e], __bfloat162float(bias[per_row ? m : n + e])));
  }

  __device__ void row8(long long z, int m, int n, const float* v) const {
    float* c = C + z * sC + (long long)m * ldc + n;
    if (!aligned16(c)) return (*this)(z, m, n, v, 8);
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = gelu_tanh(__fadd_rn(v[e], __bfloat162float(bias[per_row ? m : n + e])));
    store8(c, out);
  }
};

// C = bf16(R + (v + bias)) (bias_first) or bf16((R + v) + bias); bias per
// row or per column; R and C bf16 with the same layout. row8: eight
// columns of the s8 wgmma core's epilogue, the same arithmetic, as one
// 16-byte load and one 16-byte store where R and C are aligned.
struct ResidBias {
  const bf16* R;
  const bf16* bias;
  int per_row;
  int bias_first;
  bf16* C;
  int ldc;
  long long sC;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const long long o = z * sC + (long long)m * ldc + n;
    for (int e = 0; e < cnt; ++e) {
      const float r = __bfloat162float(R[o + e]);
      const float b = __bfloat162float(bias[per_row ? m : n + e]);
      C[o + e] = __float2bfloat16(bias_first ? __fadd_rn(r, __fadd_rn(v[e], b))
                                             : __fadd_rn(__fadd_rn(r, v[e]), b));
    }
  }

  __device__ void row8(long long z, int m, int n, const float* v) const {
    const long long o = z * sC + (long long)m * ldc + n;
    if (!aligned16(R + o) || !aligned16(C + o)) return (*this)(z, m, n, v, 8);
    const uint4 res = *reinterpret_cast<const uint4*>(R + o);
    const bf16* rv = reinterpret_cast<const bf16*>(&res);
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float r = __bfloat162float(rv[e]);
      const float b = __bfloat162float(bias[per_row ? m : n + e]);
      out[e] = bias_first ? __fadd_rn(r, __fadd_rn(v[e], b)) : __fadd_rn(__fadd_rn(r, v[e]), b);
    }
    store8(C + o, out);
  }
};

// Launch on `stream`; returns cudaErrorInvalidValue for operands the kernel
// does not take, else cudaGetLastError() of the launch.
template <class Epi>
cudaError_t gemm(cudaStream_t stream, int batch, int M, int N, int K, int chunk,
                 const void* A, int lda, long long sA, const void* B, int ldb, long long sB,
                 const Scales& sc, const Epi& epi) {
  if (K % 32 || chunk <= 0 || chunk % 32 || K % chunk || !vec_ok(A, lda, sA, 1) ||
      !vec_ok(B, ldb, sB, 1))
    return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<Epi><<<grid, THREADS, 0, stream>>>(
      M, N, K, chunk, static_cast<const int8_t*>(A), lda, sA, static_cast<const int8_t*>(B),
      ldb, sB, sc, epi);
  return cudaGetLastError();
}

}  // namespace s8gemm
}  // namespace jmt
