// Mixer block training kernels in bf16 for Hopper (sm_90a), with a plain C
// interface: the forward that also hands back h, and the three backward
// kernels.
//
// Replaces the Pallas TPU kernels of jittor_mlp_tpu/ops/pallas/
// mixer_block_bwd.py: _fwd_with_h, _token_bwd, _chan_data_bwd and
// _chan_wgt_bwd. With the forward of mixer_block.cu (xn = bf16(LN1(x)),
// tp = Wt1·xn + bt1, t = bf16(act(tp)), h = bf16(x + Wt2·t + bt2),
// hn = bf16(LN2(h)), cp = hn·Wc1ᵀ + bc1, c = bf16(act(cp)),
// out = bf16(h + c·Wc2ᵀ + bc2)) and g = dL/dout, they compute, with the
// Pallas kernels' rounding points:
//   chan data:  dcp = bf16((g·Wc2)·act'(cp));  dhn = dcp·Wc1 (f32)
//               dh = bf16(g + LN_bwd(dhn)), dln2w = Σ dhn·ĥ, dln2b = Σ dhn
//   chan wgt:   dbc1 = Σ (g·Wc2)·act'(cp) (f32, before the bf16 cast)
//               dWc1 = dcpᵀ·hn, dWc2 = gᵀ·c (f32, torch layouts)
//   token:      dWt2 = Σ_b dh_b·t_bᵀ;  dtp = (Wt2ᵀ·dh)·act'(tp)
//               dbt1 = Σ dtp (f32, before the cast);  dWt1 = Σ_b bf16(dtp)_b·xn_bᵀ
//               dxn = Wt1ᵀ·bf16(dtp);  dx = bf16(dh + LN_bwd(dxn)),
//               dln1w = Σ dxn·x̂, dln1b = Σ dxn
// with act the tanh-form GELU, act' its derivative in f32, and
// LN_bwd(d) = inv·(d·w − mean(d·w) − x̂·mean(d·w·x̂)), x̂ and inv recomputed
// in f32 from the bf16 input (eps 1e-5, biased variance). The f32
// pre-activations tp and cp are recomputed from the same bf16 operands as
// the forward and act' is applied to them, never to the stored t or c.
//
// What bounds each entry on this card (Mixer-B/16 at b256, bf16 dense peak
// 989 TFLOP/s, HBM 3.35 TB/s), and what the design does about it:
// - mixer_fwd_with_h_bf16: 533 GFLOP, 0.539 ms; kernel 1's launches
//   (mixer_forward.cuh, its four products on gemm_sm90.cuh's wgmma core)
//   with h handed to the caller.
// - mixer_token_bwd_bf16: 148 GFLOP with the recompute of the token
//   forward, 0.150 ms; but its data flow binds: 2.06 GB, 0.62 ms (3.20 GB,
//   0.95 ms, where f32 tp went through device memory four times). All five
//   products on the wgmma core:
//   1. xn = bf16(LN1(x)); Wt1 copied into rows of Np = round_up(N, 8) (its
//      392-byte rows are no TMA stride) and Wt2ᵀ into another (TD, Np)
//      buffer (a 32 × 32 tiled transpose), so that both A operands of the
//      dual product are K-major and the mode keeps one (TA, TB).
//   2. One dual product an image (the core's dual mode, 192×64 tiles: xn_b
//      and dh_b are N-major B operands), K = N tokens: v1 = Wt1·xn_b,
//      v2 = Wt2ᵀ·dh_b; its epilogue (TokenDual) keeps tp = v1 + bt1 in
//      registers and writes t = bf16(act(tp)), dtp = bf16(v2·act'(tp)) and
//      dbt1's partials, the sum of each run of eight columns of the f32 d
//      (B × TD × ⌈D/8⌉ f32, 38 MB, not 302), which a row pass adds in a
//      fixed order.
//   3. dWt2 = Σ_b dh_b·t_bᵀ and dWt1 = Σ_b dtp_b·xn_bᵀ in the core's Group
//      mode: both operands K-major per image (K = D), each tile's K loop
//      walks the images of its group through the 3-D tensor maps, one f32
//      partial a group, added by sum_groups in a fixed order (no atomics:
//      two calls bit-equal). The TPU kernel carried f32 accumulators across
//      its sequential grid instead.
//   4. dxn = Wt1ᵀ·dtp_b an image: the padded Wt1 read MN-major (TA; M = N =
//      196 is 192 + 4 rows), dtp_b an N-major B, an f32 store.
//   5. The LayerNorm backward (rows, then columns in fixed-order groups).
//   Where to expect trouble: K = 196 is four K steps, so the ring's fill is
//   a large share of each dual tile, and the weights are re-read from L2
//   for each of a row of tiles; N = 196 leaves the second M tile of dWt2
//   and dxn (and the second N tile of dWt1) 4 rows wide.
// - mixer_chan_data_bwd_bf16: 710 GFLOP (with the recompute of hn·Wc1ᵀ),
//   0.718 ms; its data flow is 1.71 GB, 0.51 ms (2.94 GB, 0.88 ms, where f32
//   cp went out and back): bound by operations.
//   1. hn = bf16(LN2(h)); Wc2 (D, CD) copied to Wc2ᵀ (CD, D), 4.7 MB, so
//      that both B operands of the dual product are K-major.
//   2. One dual product over the B·N rows, K = D (192×96 tiles): v1 =
//      hn·Wc1ᵀ, v2 = g·Wc2; its epilogue (DualGeluGrad) writes only
//      dcp = bf16(v2·act'(v1 + bc1)): neither cp nor dc reaches device
//      memory.
//   3. dhn = dcp·Wc1 (K = CD, Wc1 (CD, D) a K×N row-major B: the core's TB
//      mode), f32.
//   4. The LayerNorm backward.
//   The Pallas kernel's full fusion, which adds into dhn chunk by chunk of
//   CD with cp, dc and dcp in VMEM, is not the design: a 192-row tile of
//   dhn (D = 768 f32 values a row) does not fit in registers beside the
//   dual product's sums.
// - mixer_chan_wgt_bwd_bf16: 947 GFLOP, 0.958 ms, all four products on the
//   wgmma core: the recompute hn·Wc1ᵀ (both operands K-major, as kernel 1's)
//   and g·Wc2 (Wc2 read N-major: the core's transposed B), then
//   dWc1 = dcpᵀ·hn and dWc2 = gᵀ·c, which contract over all B·N rows with
//   both operands MN-major (the transpose bits, TMA boxes of 64 columns ×
//   64 rows). Their 3072×768 outputs are only 64 tiles of 192×192 for 132
//   SMs, so the rows are cut into slabs of whole images, about
//   SMs / tiles of them (2 on an H100), each slab an entry of the core's
//   batch axis (a 3-D tensor map, so a slab's K tail reads zeros, not the
//   next slab's rows) writing its own f32 partial; sum_groups adds the
//   partials in slab order: split-K without atomics, two calls bit-equal.
//   The bytes bound too: cp (f32) is written, read and rewritten in place
//   by the two recompute products and read again by dbc1's column sums,
//   and c and dcp (bf16) go out and back: ≈ 4 GB at b256, ≈ 1.2 ms at
//   3.35 TB/s, above the operation bound. Measured at b256 on an H100 80GB
//   HBM3 at 700 W (chip_smoke.py phase 5, two runs): 2.72–2.76 ms (7.47 with
//   all four on the WMMA core), its four products alone 1.62 ms: the slab
//   products at 762–789 TFLOP/s, the recompute products at 459–479 with
//   plain f32 stores and slower with their f32 epilogues.
// Bias and LayerNorm gradients are f32 sums of pre-rounding values, taken
// by fixed-order row and column reductions. The two channel entries each
// recompute LN2 and hn·Wc1ᵀ, as the TPU kernels do. Products that TMA
// cannot load (rows not 16 bytes apart: D % 8 ≠ 0, or CD % 8 ≠ 0 for dhn)
// take the WMMA core, chosen from the shapes (the token entry decides from
// D alone, so that its image groups are known before it runs): there a
// dual product is two products with v1 through an f32 buffer, and the
// image groups are gemm_sum's; every product is counted per route
// (mixer_bwd_gemm_products), every wgmma launch per mode
// (mixer_bwd_mode_launches).

#include <algorithm>

#include "mixer_forward.cuh"

using namespace jmt;

namespace {

constexpr int COL_GROUPS = 64;  // row groups of the column sums

// JMT_CHECK for the helpers below, which return cudaError_t.
#define BWD_CHECK(call)                     \
  do {                                      \
    const cudaError_t e_ = (call);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

// d/dx of the tanh-form GELU, in f32.
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  const float t = tanhf(u);
  const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

// Whether C's f32 (P) and bf16 (G, where given) rows allow 16-byte access of
// eight columns at a time.
inline bool vec8(const float* P, const bf16* G, int ldc, long long sC) {
  return vec_ok(P, ldc, sC, 4) && ldc % 8 == 0 && sC % 8 == 0 && (!G || vec_ok(G, ldc, sC));
}

// P = acc + bias[n] (f32), kept for the activation's derivative, and
// A = bf16(gelu_tanh(P)): the channel weight backward's recompute of cp
// and c over the B·N rows.
struct BiasPreact {
  const bf16* bias;
  float* P;
  bf16* A;
  int ldc;
  bool vec;

  BiasPreact(const void* bias_, float* P_, bf16* A_, int ldc_)
      : bias(static_cast<const bf16*>(bias_)), P(P_), A(A_), ldc(ldc_),
        vec(vec8(P_, A_, ldc_, 0)) {}

  __device__ void operator()(long long, int m, int n, const float* v, int cnt) const {
    const size_t o = (size_t)m * ldc + n;
    float p[8], a[8];
    for (int e = 0; e < cnt; ++e) {
      p[e] = v[e] + __bfloat162float(bias[n + e]);
      a[e] = gelu_tanh(p[e]);
    }
    if (vec && cnt == 8) {
      store8(P + o, p);
      store8(A + o, a);
    } else {
      for (int e = 0; e < cnt; ++e) {
        P[o + e] = p[e];
        A[o + e] = __float2bfloat16(a[e]);
      }
    }
  }
};

// d = acc · gelu_tanh'(P), P the f32 pre-activation at the same place:
// P = d (in place, for the bias gradient) and G = bf16(d).
struct GeluGrad {
  float* P;
  bf16* G;
  int ldc;
  bool vec;

  GeluGrad(float* P_, bf16* G_, int ldc_)
      : P(P_), G(G_), ldc(ldc_), vec(vec8(P_, G_, ldc_, 0)) {}

  __device__ void operator()(long long, int m, int n, const float* v, int cnt) const {
    const size_t o = (size_t)m * ldc + n;
    float d[8];
    if (vec && cnt == 8) {
      load8(P + o, d);
    } else {
      for (int e = 0; e < cnt; ++e) d[e] = P[o + e];
    }
    for (int e = 0; e < cnt; ++e) d[e] = v[e] * gelu_tanh_grad(d[e]);
    if (vec && cnt == 8) {
      store8(P + o, d);
      store8(G + o, d);
    } else {
      for (int e = 0; e < cnt; ++e) {
        P[o + e] = d[e];
        G[o + e] = __float2bfloat16(d[e]);
      }
    }
  }
};

// C = acc in f32.
struct StoreF32 {
  float* C;
  int ldc;
  long long sC;
  bool vec;

  StoreF32(float* C_, int ldc_, long long sC_)
      : C(C_), ldc(ldc_), sC(sC_), vec(vec8(C_, nullptr, ldc_, sC_)) {}

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    float* o = C + z * sC + (size_t)m * ldc + n;
    if (vec && cnt == 8) {
      store8(o, v);
    } else {
      for (int e = 0; e < cnt; ++e) o[e] = v[e];
    }
  }
};

// The channel data backward's dual epilogue: v1 = hn·Wc1ᵀ, v2 = g·Wc2 (f32
// sums of row m, columns n ..); dcp = bf16(v2 · act'(v1 + bias[n])). Neither
// cp nor dc leaves the registers.
struct DualGeluGrad {
  const bf16* bias;
  bf16* G;
  int ldc;
  bool vec;

  DualGeluGrad(const void* bias_, bf16* G_, int ldc_)
      : bias(static_cast<const bf16*>(bias_)), G(G_), ldc(ldc_), vec(vec8(nullptr, G_, ldc_, 0)) {}

  __device__ void operator()(long long, int m, int n, const float* v1, const float* v2,
                             int cnt) const {
    const size_t o = (size_t)m * ldc + n;
    float d[8];
    if (vec && cnt == 8) {
      const uint4 bv = col8(bias, n);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = v2[e] * gelu_tanh_grad(v1[e] + at8(bv, e));
      store8(G + o, d);
    } else {
      for (int e = 0; e < cnt; ++e)
        G[o + e] = __float2bfloat16(v2[e] * gelu_tanh_grad(v1[e] + __bfloat162float(bias[n + e])));
    }
  }
};

// The token backward's dual epilogue for image z, row m (of TD), columns
// n .. (of D): v1 = Wt1·xn_z, v2 = Wt2ᵀ·dh_z; tp = v1 + bias[m] (f32, in
// registers only), t = bf16(act(tp)), d = v2 · act'(tp), dtp = bf16(d), and
// the dbt1 partial P[(z·TD + m)·pcols + n/8] = Σ d over the run's columns,
// in order.
struct TokenDual {
  const bf16* bias;
  bf16 *T, *G;
  float* P;
  int TD, D, pcols;
  bool vec;

  TokenDual(const void* bias_, bf16* T_, bf16* G_, float* P_, int TD_, int D_)
      : bias(static_cast<const bf16*>(bias_)), T(T_), G(G_), P(P_), TD(TD_), D(D_),
        pcols((D_ + 7) / 8), vec(vec8(nullptr, T_, D_, 0) && vec8(nullptr, G_, D_, 0)) {}

  __device__ void operator()(long long z, int m, int n, const float* v1, const float* v2,
                             int cnt) const {
    const size_t row = (size_t)z * TD + m, o = row * D + n;
    const float b = __bfloat162float(bias[m]);
    float t[8], d[8], sum = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e < cnt) {
        const float tp = v1[e] + b;
        t[e] = gelu_tanh(tp);
        d[e] = v2[e] * gelu_tanh_grad(tp);
        sum += d[e];
      }
    }
    P[row * pcols + n / 8] = sum;
    if (vec && cnt == 8) {
      store8(T + o, t);
      store8(G + o, d);
    } else {
      for (int e = 0; e < cnt; ++e) {
        T[o + e] = __float2bfloat16(t[e]);
        G[o + e] = __float2bfloat16(d[e]);
      }
    }
  }
};

// out[c·ldo + r] = in[r·C + c] for r < R, c < C (the row-major R × C
// matrix transposed into rows of ldo ≥ R), zero for R ≤ r < ldo: 32 × 32
// tiles through shared memory, both sides coalesced.
__global__ void transpose_pad_kernel(const bf16* __restrict__ in, int R, int C,
                                     bf16* __restrict__ out, int ldo) {
  __shared__ bf16 tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    tile[i][threadIdx.x] = r < R && c < C ? in[(size_t)r * C + c] : __float2bfloat16(0.0f);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < C && r < ldo) out[(size_t)c * ldo + r] = tile[threadIdx.x][i];
  }
}

cudaError_t transpose_pad(cudaStream_t s, const void* in, int R, int C, bf16* out, int ldo) {
  transpose_pad_kernel<<<dim3((ldo + 31) / 32, (C + 31) / 32), dim3(32, 8), 0, s>>>(
      static_cast<const bf16*>(in), R, C, out, ldo);
  return cudaGetLastError();
}

// out[i] = Σ_g P[g·n + i], g = 0 .. G−1 in order.
__global__ void sum_groups_kernel(const float* __restrict__ P, int G, long long n,
                                  float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s += P[g * n + i];
    out[i] = s;
  }
}

cudaError_t sum_groups(cudaStream_t s, const float* P, int G, long long n, void* out) {
  const long long blocks = (n + 255) / 256;
  sum_groups_kernel<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, s>>>(
      P, G, n, static_cast<float*>(out));
  return cudaGetLastError();
}

// R[r] = Σ_c X[r·cols + c]: one warp a row, lane-strided, then warp_sum.
__global__ void row_sum_kernel(const float* __restrict__ X, int rows, int cols,
                               float* __restrict__ R) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = X + (size_t)row * cols;
  float s = 0.0f;
  for (int c = lane; c < cols; c += 32) s += xr[c];
  s = warp_sum(s);
  if (lane == 0) R[row] = s;
}

// P[g·cols + c] = Σ X[r·cols + c] over rows r of group g (rpg rows each).
__global__ void col_sum_kernel(const float* __restrict__ X, int rows, int cols, int rpg,
                               float* __restrict__ P) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (c >= cols) return;
  const int r1 = min(rows, (g + 1) * rpg);
  float s = 0.0f;
  for (int r = g * rpg; r < r1; ++r) s += X[(size_t)r * cols + c];
  P[(size_t)g * cols + c] = s;
}

// One warp a row: x̂ and inv recomputed in f32 from the bf16 x (as the
// forward's layer_norm_kernel), dy = dxn·w,
// out = bf16(R + inv·(dy − mean(dy) − x̂·mean(dy·x̂))); mu and inv kept for
// the column sums.
__global__ void ln_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
                                   const bf16* __restrict__ w, const bf16* __restrict__ R,
                                   bf16* __restrict__ out, float* __restrict__ mu_out,
                                   float* __restrict__ inv_out, int rows, int D, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t o = (size_t)row * D;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += __bfloat162float(x[o + c]);
  const float mu = warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = __bfloat162float(x[o + c]) - mu;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / D + eps);
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float dy = dxn[o + c] * __bfloat162float(w[c]);
    s1 += dy;
    s2 += dy * ((__bfloat162float(x[o + c]) - mu) * inv);
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  for (int c = lane; c < D; c += 32) {
    const float xhat = (__bfloat162float(x[o + c]) - mu) * inv;
    const float dy = dxn[o + c] * __bfloat162float(w[c]);
    out[o + c] = __float2bfloat16(__bfloat162float(R[o + c]) + inv * (dy - m1 - xhat * m2));
  }
  if (lane == 0) {
    mu_out[row] = mu;
    inv_out[row] = inv;
  }
}

// Pw[g·D + c] = Σ dxn·x̂ and Pb[g·D + c] = Σ dxn over rows of group g.
__global__ void ln_grad_cols_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
                                    const float* __restrict__ mu, const float* __restrict__ inv,
                                    int rows, int D, int rpg, float* __restrict__ Pw,
                                    float* __restrict__ Pb) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (c >= D) return;
  const int r1 = min(rows, (g + 1) * rpg);
  float sw = 0.0f, sb = 0.0f;
  for (int r = g * rpg; r < r1; ++r) {
    const size_t o = (size_t)r * D + c;
    const float xhat = (__bfloat162float(x[o]) - mu[r]) * inv[r];
    sw += dxn[o] * xhat;
    sb += dxn[o];
  }
  Pw[(size_t)g * D + c] = sw;
  Pb[(size_t)g * D + c] = sb;
}

inline int col_groups(int rows) { return rows < COL_GROUPS ? rows : COL_GROUPS; }
inline int rows_per_group(int rows) { return (rows + col_groups(rows) - 1) / col_groups(rows); }

// dbias (cols) = column sums of X (rows × cols f32), through P (groups × cols).
cudaError_t col_sum(cudaStream_t s, const float* X, int rows, int cols, float* P, void* out) {
  const int rpg = rows_per_group(rows), G = (rows + rpg - 1) / rpg;
  col_sum_kernel<<<dim3((cols + 255) / 256, G), 256, 0, s>>>(X, rows, cols, rpg, P);
  BWD_CHECK(cudaGetLastError());
  return sum_groups(s, P, G, cols, out);
}

// The LayerNorm backward of `rows` rows of D: out = bf16(R + LN_bwd(dxn))
// and the f32 weight/bias gradients dw, db (D each).
struct LnScratch {
  float *mu, *inv, *pw, *pb;
};

cudaError_t ln_backward(cudaStream_t s, const void* x, const float* dxn, const void* w,
                        const void* R, void* out, int rows, int D, LnScratch ls, void* dw,
                        void* db) {
  constexpr int ROWS_PER_BLOCK = 8;
  ln_bwd_rows_kernel<<<(rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, ROWS_PER_BLOCK * 32, 0, s>>>(
      static_cast<const bf16*>(x), dxn, static_cast<const bf16*>(w),
      static_cast<const bf16*>(R), static_cast<bf16*>(out), ls.mu, ls.inv, rows, D, 1e-5f);
  BWD_CHECK(cudaGetLastError());
  const int rpg = rows_per_group(rows), G = (rows + rpg - 1) / rpg;
  ln_grad_cols_kernel<<<dim3((D + 255) / 256, G), 256, 0, s>>>(
      static_cast<const bf16*>(x), dxn, ls.mu, ls.inv, rows, D, rpg, ls.pw, ls.pb);
  BWD_CHECK(cudaGetLastError());
  BWD_CHECK(sum_groups(s, ls.pw, G, D, dw));
  return sum_groups(s, ls.pb, G, D, db);
}

LnScratch ln_scratch(Carver& cv, int rows, int D) {
  const size_t G = col_groups(rows);
  LnScratch ls;
  ls.mu = cv.take<float>(rows);
  ls.inv = cv.take<float>(rows);
  ls.pw = cv.take<float>(G * D);
  ls.pb = cv.take<float>(G * D);
  return ls;
}

// ---- token backward ----------------------------------------------------

struct TokenWork {
  bf16 *xn, *t, *dtp, *wt1, *wt2t;  // wt1: Wt1 in rows of Np; wt2t: Wt2ᵀ in rows of Np
  float *dxn, *pb, *rs, *p1, *p2, *v1;  // pb: dbt1's partials; v1: the WMMA route's Wt1·xn
  LnScratch ln;
  int per, groups, Np;
  bool sm90;  // every product on the wgmma core (D % 8 == 0), else on WMMA
};

TokenWork token_work(char* base, size_t* bytes, int B, int N, int D, int TD, int sms) {
  Carver cv{base};
  TokenWork w{};
  const size_t nd = (size_t)B * N * D, td = (size_t)B * TD * D;
  w.sm90 = D % 8 == 0;  // rows of xn, dh, t and dtp 16-byte multiples apart, which TMA needs
  w.Np = round_up(N, 8);
  // dWt1 (TD × N) and dWt2 (N × TD) have the same tiles on either core
  w.per = w.sm90 ? sm90::images_per_group(B, TD, N, sms)
                 : bf16gemm::images_per_group(B, TD, N, sms);
  w.groups = (B + w.per - 1) / w.per;
  w.xn = cv.take<bf16>(nd);
  w.t = cv.take<bf16>(td);
  w.dtp = cv.take<bf16>(td);
  w.wt1 = cv.take<bf16>((size_t)TD * w.Np);
  w.wt2t = cv.take<bf16>((size_t)TD * w.Np);
  w.dxn = cv.take<float>(nd);
  w.pb = cv.take<float>((size_t)B * TD * ((D + 7) / 8));
  w.rs = cv.take<float>((size_t)B * TD);
  w.p1 = cv.take<float>((size_t)w.groups * TD * N);
  w.p2 = cv.take<float>((size_t)w.groups * N * TD);
  if (!w.sm90) w.v1 = cv.take<float>(td);
  w.ln = ln_scratch(cv, B * N, D);
  if (bytes) *bytes = cv.bytes;
  return w;
}

// ---- channel backward --------------------------------------------------

struct ChanWork {
  bf16 *hn, *c, *dcp, *wc2t;  // wc2t: Wc2ᵀ (CD, D), the data entry's
  float *cp, *dhn, *pcol, *pc1, *pc2, *v1;  // v1: the data entry's WMMA route's hn·Wc1ᵀ
  LnScratch ln;
  int slab, slabs;  // rows of a slab of the weight-gradient sums, their count
};

// sms: the device's multiprocessor count (only the weight-gradient entry,
// wgt, uses it).
ChanWork chan_work(char* base, size_t* bytes, int B, int N, int D, int CD, bool wgt, int sms) {
  Carver cv{base};
  ChanWork w{};
  const size_t rows = (size_t)B * N;
  w.hn = cv.take<bf16>(rows * D);
  w.dcp = cv.take<bf16>(rows * CD);
  if (wgt) {
    w.cp = cv.take<float>(rows * CD);
    w.slab = sm90::images_per_group(B, CD, D, sms) * N;
    w.slabs = bf16gemm::groups((long long)rows, w.slab, 1);
    w.c = cv.take<bf16>(rows * CD);
    w.pcol = cv.take<float>((size_t)col_groups((int)rows) * CD);
    w.pc1 = cv.take<float>((size_t)w.slabs * CD * D);
    w.pc2 = cv.take<float>((size_t)w.slabs * D * CD);
  } else {
    w.wc2t = cv.take<bf16>((size_t)CD * D);
    if (D % 8) w.v1 = cv.take<float>(rows * CD);  // rows TMA cannot load: the WMMA route
    w.dhn = cv.take<float>(rows * D);
    w.ln = ln_scratch(cv, (int)rows, D);
  }
  if (bytes) *bytes = cv.bytes;
  return w;
}

// The channel weight backward's recompute: hn = bf16(LN2(h)); cp = hn·Wc1ᵀ
// + bc1 (f32) and c = bf16(act(cp)); dcp = bf16((g·Wc2)·act'(cp)), its f32
// value in cp. Both products on the wgmma core; g·Wc2 reads Wc2 (D, CD)
// N-major.
cudaError_t chan_recompute(cudaStream_t s, const void* h, const void* g, const void* ln2w,
                           const void* ln2b, const void* bc1, const void* wc1, const void* wc2,
                           const ChanWork& w, int rows, int D, int CD) {
  BWD_CHECK(layer_norm(s, h, D, ln2w, ln2b, w.hn, rows, D));
  BWD_CHECK(sm90::gemm_tn(s, rows, CD, D, w.hn, D, wc1, D, BiasPreact(bc1, w.cp, w.c, CD)));
  BWD_CHECK((sm90::gemm_bf16<false, true>(s, 1, rows, CD, D, D, g, D, 0, wc2, CD, 0,
                                          GeluGrad(w.cp, w.dcp, CD))));
  return cudaSuccess;
}

}  // namespace

// ---- entries -------------------------------------------------------------
// All activations are contiguous bf16 device buffers (B, N, D); weights in
// their torch layouts (wt1 (TD, N), wt2 (N, TD), wc1 (CD, D), wc2 (D, CD)).
// Gradients of weights, biases and LayerNorm parameters are f32. `ws` is
// device scratch of the entry's *_workspace(...) bytes. Each returns a
// cudaError_t code (0 on success) from the first launch that failed.

// Kernel 1 with h (B, N, D) for the caller. Scratch: xn (B, N, D), t
// (B, TD, D), wt1p (TD, round_up(N, 8)), c (B·N, CD).
extern "C" int mixer_fwd_with_h_bf16(const void* x, const void* ln1w, const void* ln1b,
                                     const void* wt1, const void* bt1, const void* wt2,
                                     const void* bt2, const void* ln2w, const void* ln2b,
                                     const void* wc1, const void* bc1, const void* wc2,
                                     const void* bc2, void* xn, void* t, void* wt1p, void* h,
                                     void* c, void* out, int B, int N, int D, int TD, int CD,
                                     void* stream_ptr) {
  return mixer_forward(static_cast<cudaStream_t>(stream_ptr), x, ln1w, ln1b, wt1, bt1, wt2, bt2,
                       ln2w, ln2b, wc1, bc1, wc2, bc2, xn, t, wt1p, h, c, out, B, N, D, TD, CD);
}

// The two weight-gradient entries take `sms`, the device's multiprocessor
// count, which sets how many images each f32 partial sums; their
// *_workspace and *_images_per_group take it too.
extern "C" size_t mixer_token_bwd_workspace(int B, int N, int D, int TD, int sms) {
  size_t bytes = 0;
  token_work(nullptr, &bytes, B, N, D, TD, sms);
  return bytes;
}

// Images per f32 partial of dWt1 and dWt2, as mixer_token_bwd_bf16 groups them.
extern "C" size_t mixer_token_bwd_images_per_group(int B, int N, int D, int TD, int sms) {
  return token_work(nullptr, nullptr, B, N, D, TD, sms).per;
}

// dx (B, N, D) bf16; dwt1 (TD, N), dwt2 (N, TD), dbt1 (TD), dln1w, dln1b (D) f32.
extern "C" int mixer_token_bwd_bf16(const void* x, const void* dh, const void* ln1w,
                                    const void* ln1b, const void* wt1, const void* bt1,
                                    const void* wt2, void* ws, void* dx, void* dwt1, void* dwt2,
                                    void* dbt1, void* dln1w, void* dln1b, int B, int N, int D,
                                    int TD, int sms, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const TokenWork w = token_work(static_cast<char*>(ws), nullptr, B, N, D, TD, sms);
  const long long nd = (long long)N * D, td = (long long)TD * D;
  const int Np = w.Np;
  const sm90::Core core = w.sm90 ? sm90::Core::Sm90 : sm90::Core::Legacy;
  // recompute: xn = bf16(LN1(x))
  JMT_CHECK(layer_norm(s, x, D, ln1w, ln1b, w.xn, B * N, D));
  // Wt1 → rows of Np, zero past column N; Wt2ᵀ → rows of Np, the same
  JMT_CHECK(cudaMemsetAsync(w.wt1, 0, sizeof(bf16) * TD * Np, s));
  JMT_CHECK(cudaMemcpy2DAsync(w.wt1, sizeof(bf16) * Np, wt1, sizeof(bf16) * N, sizeof(bf16) * N,
                              TD, cudaMemcpyDeviceToDevice, s));
  JMT_CHECK(transpose_pad(s, wt2, N, TD, w.wt2t, Np));
  // one dual product an image, K = N tokens: v1 = Wt1·xn_b, v2 = Wt2ᵀ·dh_b
  // (the weights shared, xn_b and dh_b N-major); t = bf16(act(v1 + bt1)),
  // dtp = bf16(v2·act'(v1 + bt1)) and dbt1's partials, tp in registers only
  JMT_CHECK((sm90::gemm_bf16_dual<false, true>(
      s, B, TD, D, N, sm90::Operand{w.wt1, Np, 0}, sm90::Operand{w.xn, D, nd},
      sm90::Operand{w.wt2t, Np, 0}, sm90::Operand{dh, D, nd},
      TokenDual(bt1, w.t, w.dtp, w.pb, TD, D), w.v1, core)));
  // dbt1 = Σ over images of Σ over each image's column runs, in order
  row_sum_kernel<<<(B * TD + 7) / 8, 256, 0, s>>>(w.pb, B * TD, (D + 7) / 8, w.rs);
  JMT_CHECK(cudaGetLastError());
  JMT_CHECK(sum_groups(s, w.rs, B, TD, dbt1));
  // dWt2 = Σ_b dh_b·t_bᵀ and dWt1 = Σ_b dtp_b·xn_bᵀ (K = D an image): groups
  // of w.per images in the core's K loop, one f32 partial a group, the
  // partials added in order
  JMT_CHECK((sm90::gemm_bf16_grouped(s, B, w.per, N, TD, D, dh, D, nd, w.t, D, td,
                                     StoreF32(w.p2, TD, (long long)N * TD), core)));
  JMT_CHECK(sum_groups(s, w.p2, w.groups, (long long)N * TD, dwt2));
  JMT_CHECK((sm90::gemm_bf16_grouped(s, B, w.per, TD, N, D, w.dtp, D, td, w.xn, D, nd,
                                     StoreF32(w.p1, N, (long long)TD * N), core)));
  JMT_CHECK(sum_groups(s, w.p1, w.groups, (long long)TD * N, dwt1));
  // dxn = Wt1ᵀ·dtp_b (f32): the padded Wt1 read MN-major (M = N tokens),
  // dtp_b N-major; dx = bf16(dh + LN1_bwd(dxn)) and the LN1 gradients
  JMT_CHECK((sm90::gemm_bf16<true, true>(s, B, N, D, TD, TD, w.wt1, Np, 0, w.dtp, D, td,
                                         StoreF32(w.dxn, D, nd), core)));
  return (int)ln_backward(s, x, w.dxn, ln1w, dh, dx, B * N, D, w.ln, dln1w, dln1b);
}

extern "C" size_t mixer_chan_data_bwd_workspace(int B, int N, int D, int CD) {
  size_t bytes = 0;
  chan_work(nullptr, &bytes, B, N, D, CD, false, 0);
  return bytes;
}

// dh (B, N, D) bf16; dln2w, dln2b (D) f32.
extern "C" int mixer_chan_data_bwd_bf16(const void* h, const void* g, const void* ln2w,
                                        const void* ln2b, const void* bc1, const void* wc1,
                                        const void* wc2, void* ws, void* dh, void* dln2w,
                                        void* dln2b, int B, int N, int D, int CD,
                                        void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const ChanWork w = chan_work(static_cast<char*>(ws), nullptr, B, N, D, CD, false, 0);
  const int rows = B * N;
  // hn = bf16(LN2(h)); Wc2 (D, CD) → Wc2ᵀ (CD, D), so that both B operands
  // of the dual product are K-major
  JMT_CHECK(layer_norm(s, h, D, ln2w, ln2b, w.hn, rows, D));
  JMT_CHECK(transpose_pad(s, wc2, D, CD, w.wc2t, D));
  // one dual product over the B·N rows, K = D: v1 = hn·Wc1ᵀ, v2 = g·Wc2;
  // dcp = bf16(v2·act'(v1 + bc1)), cp and dc in registers only
  JMT_CHECK((sm90::gemm_bf16_dual<false, false>(
      s, 1, rows, CD, D, sm90::Operand{w.hn, D, 0}, sm90::Operand{wc1, D, 0},
      sm90::Operand{g, D, 0}, sm90::Operand{w.wc2t, D, 0}, DualGeluGrad(bc1, w.dcp, CD), w.v1)));
  // dhn = dcp·Wc1 (f32, K = CD): Wc1 (CD, D) a K×N row-major B
  JMT_CHECK((sm90::gemm_bf16<false, true>(s, 1, rows, D, CD, CD, w.dcp, CD, 0, wc1, D, 0,
                                          StoreF32(w.dhn, D, 0))));
  return (int)ln_backward(s, h, w.dhn, ln2w, g, dh, rows, D, w.ln, dln2w, dln2b);
}

extern "C" size_t mixer_chan_wgt_bwd_workspace(int B, int N, int D, int CD, int sms) {
  size_t bytes = 0;
  chan_work(nullptr, &bytes, B, N, D, CD, true, sms);
  return bytes;
}

// Images per row slab (f32 partial) of dWc1 and dWc2, as mixer_chan_wgt_bwd_bf16
// cuts them.
extern "C" size_t mixer_chan_wgt_bwd_images_per_group(int B, int N, int D, int CD, int sms) {
  return chan_work(nullptr, nullptr, B, N, D, CD, true, sms).slab / N;
}

// dwc1 (CD, D), dwc2 (D, CD), dbc1 (CD), all f32.
extern "C" int mixer_chan_wgt_bwd_bf16(const void* h, const void* g, const void* ln2w,
                                       const void* ln2b, const void* bc1, const void* wc1,
                                       const void* wc2, void* ws, void* dwc1, void* dwc2,
                                       void* dbc1, int B, int N, int D, int CD, int sms,
                                       void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const ChanWork w = chan_work(static_cast<char*>(ws), nullptr, B, N, D, CD, true, sms);
  const int rows = B * N;
  JMT_CHECK(chan_recompute(s, h, g, ln2w, ln2b, bc1, wc1, wc2, w, rows, D, CD));
  // dbc1 = column sums of the f32 dcp, before its bf16 cast
  JMT_CHECK(col_sum(s, w.cp, rows, CD, w.pcol, dbc1));
  // dWc1 = dcpᵀ·hn and dWc2 = gᵀ·c over all rows: both operands MN-major,
  // one entry (f32 partial) a slab of rows, the partials added in order
  const int last = rows - (w.slabs - 1) * w.slab;
  JMT_CHECK((sm90::gemm_bf16<true, true>(s, w.slabs, CD, D, w.slab, last, w.dcp, CD,
                                         (long long)w.slab * CD, w.hn, D, (long long)w.slab * D,
                                         StoreF32(w.pc1, D, (long long)CD * D))));
  JMT_CHECK(sum_groups(s, w.pc1, w.slabs, (long long)CD * D, dwc1));
  JMT_CHECK((sm90::gemm_bf16<true, true>(s, w.slabs, D, CD, w.slab, last, g, D,
                                         (long long)w.slab * D, w.c, CD, (long long)w.slab * CD,
                                         StoreF32(w.pc2, CD, (long long)D * CD))));
  return (int)sum_groups(s, w.pc2, w.slabs, (long long)D * CD, dwc2);
}

// Products this library launched on route 0 (the wgmma core) or 1 (the
// WMMA core), since it was loaded (gemm_sm90.cuh): the forward's four (two
// token, two channel), the token backward's five (a dual product counts
// two), the channel data backward's three and the channel weight
// backward's four; -1 for another route.
extern "C" long long mixer_bwd_gemm_products(int route) { return sm90::products(route); }

// Launches of the wgmma core since this library was loaded, by mode: 0 one
// product, 2 the dual mode (the token and channel data backwards), 3 the
// Group mode (the token backward's dWt1 and dWt2); -1 for another mode.
extern "C" long long mixer_bwd_mode_launches(int mode) { return sm90::mode_launches(mode); }

extern "C" const char* mixer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
