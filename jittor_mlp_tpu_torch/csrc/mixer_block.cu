// Mixer block forward in bf16 for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/mixer_block.py::
// fused_mixer_block (body `_kernel`). For x (B, N, D) it computes, with the
// same rounding points:
//   xn  = bf16(LN1(x))                                  f32 stats and affine
//   t   = bf16(gelu_tanh(Wt1 · xn + bt1))               Wt1 (TD, N), per image
//   h   = bf16(x + Wt2 · t + bt2)                       Wt2 (N, TD), per image
//   hn  = bf16(LN2(h))
//   c   = bf16(gelu_tanh(hn · Wc1^T + bc1))             Wc1 (CD, D), rows B·N
//   out = bf16(h + c · Wc2^T + bc2)                     Wc2 (D, CD)
// All products accumulate in f32 on the tensor cores (nvcuda::wmma).
//
// What bounds it on this card, and what the design does about it:
// - The TPU kernel keeps all four weight matrices in VMEM. Here Wc1 alone is
//   4.7 MB in bf16, far beyond a block's 227 KB of shared memory, so the
//   block runs as six launches on the caller's stream: LN, GEMM, GEMM, LN,
//   GEMM, GEMM. Intermediates (xn/hn, t, h, c) go through device memory; the
//   weights are shared by every image (batch stride 0) and stay in the 50 MB
//   L2 cache.
// - The channel GEMMs carry CD/(CD+TD) = 3072/3456 ≈ 89% of the FLOPs. They
//   stack all B·N rows into one M, so at serving batch sizes they are large,
//   compute-bound products: 128×128 output tiles reuse each loaded operand
//   128 times.
// - The token GEMMs (K = N = 196 and K = TD = 384) are small per image and
//   bandwidth-bound at this design: each reads and writes a whole (B, TD, D)
//   intermediate. They run batched over images (grid z) with the weight as
//   the shared A operand.
// - N = 196 is not a multiple of any tile size. It is the K of the first
//   token GEMM and the M of the second: ragged K tails are zero-filled in
//   shared memory and ragged M/N edges are masked in the epilogue, instead
//   of the TPU version's padding to 128.
// - Rows of Wt1 (384, 196) are 392 bytes apart, not 16-byte aligned. The
//   tile loader uses 16-byte cp.async copies only where the base, leading
//   dimension and batch stride allow it, and 2-byte loads elsewhere. Two
//   shared-memory stages let the copies of the next K step overlap the
//   tensor-core work of this one.
// wgmma, TMA and keeping the intermediates on chip are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;                // 8 warps: 2 along M, 4 along N
constexpr int WM = 64, WN = 32;             // one warp's output tile
constexpr int FM = WM / 16, FN = WN / 16;   // 16×16 fragments per warp
constexpr int LDK = BK + 8;                 // smem row of a K-contiguous tile
constexpr int LDN = BN + 8;                 // smem row of an N-contiguous tile

enum Epilogue { kGelu = 0, kResidual = 1 };

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

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

// C[z] (M×N) = epilogue(A[z] (M×K) · op(B[z]) + bias), z = blockIdx.z.
// B_T false: B is K×N row-major (token mix, W·xn per image).
// B_T true:  B is N×K row-major and the product uses B^T (channel mix with a
//            torch-layout weight).
// Batch strides may be 0 (a weight shared by every image). Bias is per row
// of C (token mixes) or per column (channel mixes). The residual R has C's
// layout; c_vec says C and R allow 16-byte access.
template <int EPI, bool B_T>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(int M, int N, int K,
                 const bf16* __restrict__ A, int lda, long long sA, bool a_vec,
                 const bf16* __restrict__ B, int ldb, long long sB, bool b_vec,
                 const bf16* __restrict__ bias, int bias_per_row,
                 const bf16* __restrict__ R,
                 bf16* __restrict__ C, int ldc, long long sC, bool c_vec) {
  // Two pipeline stages of (A tile, B tile); the epilogue's f32 staging
  // tiles reuse the same memory once the K loop is done.
  constexpr int A_ELEMS = BM * LDK;
  constexpr int STAGE_ELEMS = A_ELEMS + (B_T ? BN * LDK : BK * LDN);
  static_assert(2 * STAGE_ELEMS * 2 >= THREADS / 32 * 256 * 4, "staging fits");
  __shared__ __align__(128) bf16 smem[2 * STAGE_ELEMS];

  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += z * sA;
  B += z * sB;
  C += z * sC;
  if (EPI == kResidual) R += z * sC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  using LayoutB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_stage = [&](int stage, int k0) {
    bf16* As = smem + stage * STAGE_ELEMS;
    bf16* Bs = As + A_ELEMS;
    load_tile<BM, BK>(As, LDK, A + (size_t)m0 * lda + k0, lda, M - m0, K - k0, a_vec);
    if constexpr (B_T)
      load_tile<BN, BK>(Bs, LDK, B + (size_t)n0 * ldb + k0, ldb, N - n0, K - k0, b_vec);
    else
      load_tile<BK, BN>(Bs, LDN, B + (size_t)k0 * ldb + n0, ldb, K - k0, N - n0, b_vec);
  };

  // While the tensor cores work on stage kt, stage kt+1 is in flight.
  const int KT = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_1();  // this thread's copies of stage kt have landed
    __syncthreads();    // ... and everyone else's
    const bf16* As = smem + (kt & 1) * STAGE_ELEMS;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        if constexpr (B_T)
          wmma::load_matrix_sync(fb[j], Bs + (wn * WN + j * 16) * LDK + kk, LDK);
        else
          wmma::load_matrix_sync(fb[j], Bs + kk * LDN + wn * WN + j * 16, LDN);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
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
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * WM + i * 16 + r;
      const int gn0 = n0 + wn * WN + j * 16 + c0;
      if (gm < M) {
        const float brow = bias_per_row ? __bfloat162float(bias[gm]) : 0.0f;
        const size_t o = (size_t)gm * ldc + gn0;
        if (c_vec && gn0 + 8 <= N) {
          // whole 8-column chunk: one 16-byte residual load, one 16-byte store
          uint4 res, out;
          if (EPI == kResidual) res = *reinterpret_cast<const uint4*>(R + o);
          const bf16* rv = reinterpret_cast<const bf16*>(&res);
          bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float v = st[r * 16 + c0 + e] + (bias_per_row ? brow : __bfloat162float(bias[gn0 + e]));
            v = EPI == kGelu ? gelu_tanh(v) : __bfloat162float(rv[e]) + v;
            ov[e] = __float2bfloat16(v);
          }
          *reinterpret_cast<uint4*>(C + o) = out;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (gn0 + e < N) {
              float v = st[r * 16 + c0 + e] + (bias_per_row ? brow : __bfloat162float(bias[gn0 + e]));
              v = EPI == kGelu ? gelu_tanh(v) : __bfloat162float(R[o + e]) + v;
              C[o + e] = __float2bfloat16(v);
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// One warp per row: f32 two-pass statistics, f32 affine, bf16 store.
__global__ void layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                  const bf16* __restrict__ b, bf16* __restrict__ y,
                                  int rows, int cols, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * cols;
  bf16* yr = y + (size_t)row * cols;
  float s = 0.0f;
  for (int c = lane; c < cols; c += 32) s += __bfloat162float(xr[c]);
  const float mu = warp_sum(s) / cols;
  float v = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / cols + eps);
  for (int c = lane; c < cols; c += 32) {
    const float n = (__bfloat162float(xr[c]) - mu) * rstd;
    yr[c] = __float2bfloat16(n * __bfloat162float(w[c]) + __bfloat162float(b[c]));
  }
}

bool vec_ok(const void* p, long long ld, long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 && stride % 8 == 0;
}

template <int EPI, bool B_T>
cudaError_t gemm(cudaStream_t stream, int batch, int M, int N, int K,
                 const void* A, int lda, long long sA,
                 const void* B, int ldb, long long sB,
                 const void* bias, int bias_per_row, const void* R,
                 void* C, int ldc, long long sC) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_bf16_kernel<EPI, B_T><<<grid, THREADS, 0, stream>>>(
      M, N, K,
      static_cast<const bf16*>(A), lda, sA, vec_ok(A, lda, sA),
      static_cast<const bf16*>(B), ldb, sB, vec_ok(B, ldb, sB),
      static_cast<const bf16*>(bias), bias_per_row, static_cast<const bf16*>(R),
      static_cast<bf16*>(C), ldc, sC,
      vec_ok(C, ldc, sC) && (R == nullptr || vec_ok(R, ldc, sC)));
  return cudaGetLastError();
}

cudaError_t layer_norm(cudaStream_t stream, const void* x, const void* w, const void* b,
                       void* y, int rows, int cols) {
  constexpr int ROWS_PER_BLOCK = 8;
  layer_norm_kernel<<<(rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0,
                      stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                static_cast<const bf16*>(b), static_cast<bf16*>(y), rows,
                                cols, 1e-5f);
  return cudaGetLastError();
}

}  // namespace

#define CHECK(call)                      \
  do {                                   \
    cudaError_t e_ = (call);             \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// All pointers are contiguous bf16 device buffers. Scratch: xn (B, N, D),
// reused for hn; t (B, TD, D); h (B, N, D); c (B·N, CD). Returns a
// cudaError_t code (0 on success) from the first launch that failed.
extern "C" int mixer_block_bf16(const void* x, const void* ln1w, const void* ln1b,
                                const void* wt1, const void* bt1, const void* wt2,
                                const void* bt2, const void* ln2w, const void* ln2b,
                                const void* wc1, const void* bc1, const void* wc2,
                                const void* bc2, void* xn, void* t, void* h, void* c,
                                void* out, int B, int N, int D, int TD, int CD,
                                void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const long long nd = (long long)N * D, td = (long long)TD * D;
  CHECK(layer_norm(s, x, ln1w, ln1b, xn, B * N, D));
  // token mix, per image: t = gelu(Wt1 · xn + bt1); h = x + Wt2 · t + bt2
  CHECK((gemm<kGelu, false>(s, B, TD, D, N, wt1, N, 0, xn, D, nd, bt1, 1, nullptr, t, D, td)));
  CHECK((gemm<kResidual, false>(s, B, N, D, TD, wt2, TD, 0, t, D, td, bt2, 1, x, h, D, nd)));
  CHECK(layer_norm(s, h, ln2w, ln2b, xn, B * N, D));
  // channel mix over all B·N rows: c = gelu(hn · Wc1^T + bc1); out = h + c · Wc2^T + bc2
  CHECK((gemm<kGelu, true>(s, 1, B * N, CD, D, xn, D, 0, wc1, D, 0, bc1, 0, nullptr, c, CD, 0)));
  CHECK((gemm<kResidual, true>(s, 1, B * N, D, CD, c, CD, 0, wc2, CD, 0, bc2, 0, h, out, D, 0)));
  return 0;
}

extern "C" const char* mixer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
