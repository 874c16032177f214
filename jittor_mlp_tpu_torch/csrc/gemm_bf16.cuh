// Batched bf16 GEMM on the tensor cores (nvcuda::wmma, f32 accumulation)
// with a pluggable epilogue: gemm_sm90.cuh runs a bf16 product here where
// TMA cannot load its operands (and on Core::Legacy, for comparison).
//
//   C[z] (M×N) = epi(op(A[z]) · op(B[z])),   z = blockIdx.z
//   A_T false: A is M×K row-major;  A_T true: A is K×M row-major, used as Aᵀ.
//   B_T false: B is K×N row-major;  B_T true: B is N×K row-major, used as Bᵀ.
//
// Batch strides may be 0 (a weight shared by every image). Ragged K tails
// are zero-filled in shared memory; the epilogue is called only for rows
// m < M and with the count of columns < N. 128×128 output tiles, 8 warps of
// 64×32, K steps of 32 in a two-stage cp.async ring; tile copies go as
// 16-byte cp.async where base, leading dimension and batch stride allow it
// (a_vec / b_vec), else as 2-byte loads.
//
// gemm_sum: one product summed over images, C = Σ_i op(A_i)·op(B_i), for
// weight gradients. Image i is the slice i·K .. of a K axis of Ktot
// (A_i = A + i·sA, B_i = B + i·sB; the last image may be shorter). Block z
// sums images z·per .. z·per+per−1 in its K loop, in order, and its
// epilogue gets z: the caller writes per-group f32 partials and adds them
// in a fixed order, so two calls agree bit for bit (no atomics).
//
// The epilogue is a functor
//   void operator()(long long z, int m, int n, const float* v, int cnt) const
// receiving the f32 sums of row m, columns n .. n+cnt-1 (cnt ≤ 8; n is a
// multiple of 8).
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace jmt {
namespace bf16gemm {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;                // 8 warps: 2 along M, 4 along N
constexpr int WM = 64, WN = 32;             // one warp's output tile
constexpr int FM = WM / 16, FN = WN / 16;   // 16×16 fragments per warp
constexpr int LDK = BK + 8;                 // smem row of a K-contiguous tile
constexpr int LDN = BN + 8;                 // smem row of an N-contiguous tile
constexpr int LDM = BM + 8;                 // smem row of an M-contiguous (Aᵀ) tile

// Copy an R×C tile (row-major, leading dimension ldg, origin g) into shared
// memory with leading dimension lds. Only rows < rows and columns < cols are
// read; the rest is zero-filled, so ragged K tails contribute nothing to the
// product. Where 16-byte access is allowed (vec) whole chunks go by
// cp.async (rows past the edge as a 0-byte copy, which zero-fills); the
// rest by 2-byte loads and stores.
template <int R, int C>
__device__ __forceinline__ void load_tile(bf16* __restrict__ s, int lds,
                                          const bf16* __restrict__ g, int ldg,
                                          int rows, int cols, bool vec) {
  constexpr int CPR = C / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
    const int r = i / CPR, k = (i % CPR) * 8;
    bf16* dst = s + r * lds + k;
    const bf16* src = g + (size_t)r * ldg + k;
    if (vec && k + 8 <= cols) {
      if (r < rows)
        cp_async16(dst, src, 16);
      else
        cp_async16(dst, g, 0);  // g, the tile origin, is in bounds
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (r < rows && k + j < cols) ? src[j] : __float2bfloat16(0.0f);
    }
  }
}

template <bool A_T, bool B_T, bool SUM, class Epi>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(int M, int N, int K, const bf16* __restrict__ A, int lda, long long sA, bool a_vec,
            const bf16* __restrict__ B, int ldb, long long sB, bool b_vec, long long Ktot,
            int per, Epi epi) {
  // Two pipeline stages of (A tile, B tile); the epilogue's f32 staging
  // tiles reuse the same memory once the K loop is done.
  constexpr int A_ELEMS = A_T ? BK * LDM : BM * LDK;
  constexpr int STAGE_ELEMS = A_ELEMS + (B_T ? BN * LDK : BK * LDN);
  static_assert(2 * STAGE_ELEMS * 2 >= THREADS / 32 * 256 * 4, "staging fits");
  __shared__ __align__(128) bf16 smem[2 * STAGE_ELEMS];

  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  // Images this block sums: z alone, or (SUM) z·per .. within Ktot.
  const int KT = (K + BK - 1) / BK;  // K steps of a full image
  long long img0 = z;
  int steps = KT;
  if constexpr (SUM) {
    const long long images = (Ktot + K - 1) / K;
    img0 = z * per;
    const int nimg = (int)min((long long)per, images - img0);
    const long long k_last = min((long long)K, Ktot - (img0 + nimg - 1) * K);
    steps = (nimg - 1) * KT + (int)((k_last + BK - 1) / BK);
  }

  using LayoutA = typename std::conditional<A_T, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using LayoutB = typename std::conditional<B_T, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);

  // Step s: K step s % KT of image img0 + s / KT.
  auto load_stage = [&](int stage, int s) {
    const int i = SUM ? s / KT : 0;
    const int k0 = (s - i * KT) * BK;
    const long long img = img0 + i;
    const int kl = SUM ? (int)min((long long)K, Ktot - img * K) : K;  // this image's K
    const bf16* Ai = A + img * sA;
    const bf16* Bi = B + img * sB;
    bf16* As = smem + stage * STAGE_ELEMS;
    bf16* Bs = As + A_ELEMS;
    if constexpr (A_T)
      load_tile<BK, BM>(As, LDM, Ai + (size_t)k0 * lda + m0, lda, kl - k0, M - m0, a_vec);
    else
      load_tile<BM, BK>(As, LDK, Ai + (size_t)m0 * lda + k0, lda, M - m0, kl - k0, a_vec);
    if constexpr (B_T)
      load_tile<BN, BK>(Bs, LDK, Bi + (size_t)n0 * ldb + k0, ldb, N - n0, kl - k0, b_vec);
    else
      load_tile<BK, BN>(Bs, LDN, Bi + (size_t)k0 * ldb + n0, ldb, kl - k0, N - n0, b_vec);
  };

  // While the tensor cores work on stage kt, stage kt+1 is in flight.
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < steps; ++kt) {
    if (kt + 1 < steps) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait_1();  // this thread's copies of stage kt have landed
    __syncthreads();    // ... and everyone else's
    const bf16* As = smem + (kt & 1) * STAGE_ELEMS;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[FM];
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if constexpr (A_T)
          nvcuda::wmma::load_matrix_sync(fa[i], As + kk * LDM + wm * WM + i * 16, LDM);
        else
          nvcuda::wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDK + kk, LDK);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        if constexpr (B_T)
          nvcuda::wmma::load_matrix_sync(fb[j], Bs + (wn * WN + j * 16) * LDK + kk, LDK);
        else
          nvcuda::wmma::load_matrix_sync(fb[j], Bs + kk * LDN + wn * WN + j * 16, LDN);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // stage kt is free for the copies of kt+2
  }

  // Epilogue: each fragment goes through the warp's f32 staging tile; lane
  // pairs own one row of it, 8 columns each.
  float* st = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      nvcuda::wmma::store_matrix_sync(st, acc[i][j], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * WM + i * 16 + r;
      const int gn0 = n0 + wn * WN + j * 16 + c0;
      if (gm < M && gn0 < N) epi(z, gm, gn0, st + r * 16 + c0, min(8, N - gn0));
      __syncwarp();
    }
  }
}

// C = bf16(gelu_tanh(acc + bias)); bias per row of C (token mix) or per
// column (channel mix). vec: C allows 16-byte stores.
struct GeluBias {
  const bf16* bias;
  int per_row;
  bf16* C;
  int ldc;
  long long sC;
  bool vec;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const size_t o = z * sC + (size_t)m * ldc + n;
    const float brow = per_row ? __bfloat162float(bias[m]) : 0.0f;
    if (vec && cnt == 8) {  // one 16-byte store
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ov[e] = __float2bfloat16(
            gelu_tanh(v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
      *reinterpret_cast<uint4*>(C + o) = out;
    } else {
      for (int e = 0; e < cnt; ++e)
        C[o + e] = __float2bfloat16(
            gelu_tanh(v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
    }
  }
};

inline GeluBias gelu_bias(const void* bias, int per_row, void* C, int ldc, long long sC) {
  return {static_cast<const bf16*>(bias), per_row, static_cast<bf16*>(C), ldc, sC,
          vec_ok(C, ldc, sC)};
}

// C = bf16(R + (acc + bias)); R has C's layout. vec: C and R allow 16-byte
// access.
struct ResidualBias {
  const bf16* bias;
  int per_row;
  const bf16* R;
  bf16* C;
  int ldc;
  long long sC;
  bool vec;

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const size_t o = z * sC + (size_t)m * ldc + n;
    const float brow = per_row ? __bfloat162float(bias[m]) : 0.0f;
    if (vec && cnt == 8) {  // one 16-byte residual load, one 16-byte store
      const uint4 res = *reinterpret_cast<const uint4*>(R + o);
      const bf16* rv = reinterpret_cast<const bf16*>(&res);
      uint4 out;
      bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ov[e] = __float2bfloat16(__bfloat162float(rv[e]) +
                                 (v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
      *reinterpret_cast<uint4*>(C + o) = out;
    } else {
      for (int e = 0; e < cnt; ++e)
        C[o + e] = __float2bfloat16(__bfloat162float(R[o + e]) +
                                    (v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
    }
  }
};

inline ResidualBias residual_bias(const void* bias, int per_row, const void* R, void* C,
                                  int ldc, long long sC) {
  return {static_cast<const bf16*>(bias), per_row, static_cast<const bf16*>(R),
          static_cast<bf16*>(C), ldc, sC, vec_ok(C, ldc, sC) && vec_ok(R, ldc, sC)};
}

// Launch on `stream`; returns cudaGetLastError() of the launch.
template <bool A_T, bool B_T, class Epi>
cudaError_t gemm_ex(cudaStream_t stream, int batch, int M, int N, int K,
                    const void* A, int lda, long long sA,
                    const void* B, int ldb, long long sB, const Epi& epi) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<A_T, B_T, false, Epi><<<grid, THREADS, 0, stream>>>(
      M, N, K, static_cast<const bf16*>(A), lda, sA, vec_ok(A, lda, sA),
      static_cast<const bf16*>(B), ldb, sB, vec_ok(B, ldb, sB), K, 1, epi);
  return cudaGetLastError();
}

// Σ over images of op(A_i)·op(B_i) (see the header), `per` images a block;
// the epilogue's z is the group, 0 .. groups(Ktot, K, per) − 1.
inline int groups(long long Ktot, int K, int per) {
  return (int)(((Ktot + K - 1) / K + per - 1) / per);
}

template <bool A_T, bool B_T, class Epi>
cudaError_t gemm_sum(cudaStream_t stream, long long Ktot, int K, int per, int M, int N,
                     const void* A, int lda, long long sA,
                     const void* B, int ldb, long long sB, const Epi& epi) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, groups(Ktot, K, per));
  gemm_kernel<A_T, B_T, true, Epi><<<grid, THREADS, 0, stream>>>(
      M, N, K, static_cast<const bf16*>(A), lda, sA, vec_ok(A, lda, sA),
      static_cast<const bf16*>(B), ldb, sB, vec_ok(B, ldb, sB), Ktot, per, epi);
  return cudaGetLastError();
}

// Images per group of a gemm_sum with an M×N output: enough groups to give
// each of the card's `sms` multiprocessors about 4 blocks, at most one group
// per image. The caller passes the device's count, so the grouping (and with
// it every partial sum) is fixed per device.
inline int images_per_group(long long images, int M, int N, int sms) {
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const long long want = (4LL * sms + tiles - 1) / tiles;
  const long long g = want < images ? want : images;
  return (int)((images + g - 1) / g);
}

}  // namespace bf16gemm
}  // namespace jmt
