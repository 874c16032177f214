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
// 989 TFLOP/s), and what the design does about it:
// - mixer_fwd_with_h_bf16: 533 GFLOP, 0.539 ms; kernel 1's six launches
//   (mixer_forward.cuh, its channel products on gemm_sm90.cuh's wgmma core)
//   with h handed to the caller.
// - mixer_token_bwd_bf16: 148 GFLOP (with the recompute of the token
//   forward), 0.150 ms. Six GEMMs on the shared WMMA main loop
//   (gemm_bf16.cuh). The products that contract over a weight's row axis
//   (Wt2ᵀ·dh, Wt1ᵀ·dtp) read the weight as a transposed A tile. The weight
//   gradients sum over images: the TPU kernel carries f32 accumulators
//   across its sequential grid; here gemm_sum lets each block's K loop walk
//   a group of images and write an f32 partial, and the partials are added
//   in a fixed order (no atomics: two calls agree bit for bit).
// - mixer_chan_data_bwd_bf16: 710 GFLOP (with the recompute of hn·Wc1ᵀ),
//   0.718 ms. Its two recompute products (below) run on gemm_sm90.cuh's
//   wgmma core; its own dhn = dcp·Wc1 (one K = CD product: the TPU kernel's
//   chunking of CD only fits VMEM and is not part of the function) and the
//   LayerNorm backward stay on the WMMA core and the row kernels.
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
// Every entry is bound by operations or by the bytes of its f32
// intermediates. The f32 pre-activations (tp, cp), the f32 dtp, dxn and
// dhn and the bf16 t, c and dcp go through device memory; bias and
// LayerNorm gradients are f32 sums of pre-rounding values, taken by
// fixed-order row and column reductions. The two channel entries each
// recompute LN2 and cp, as the TPU kernels do. Products that TMA cannot
// load (rows not 16 bytes apart) take the WMMA core with the same slabs,
// counted per route (mixer_bwd_gemm_products). The token products and dhn
// on wgmma, fusing the two channel recomputes and keeping intermediates on
// chip are later work.

#include <algorithm>

#include "mixer_forward.cuh"

using namespace jmt;
using bf16gemm::gemm;
using bf16gemm::gemm_ex;
using bf16gemm::gemm_sum;

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

// P = acc + bias (f32; bias per row of C or per column), kept for the
// activation's derivative; A = bf16(gelu_tanh(P)) where A is given.
struct BiasPreact {
  const bf16* bias;
  int per_row;
  float* P;
  bf16* A;
  int ldc;
  long long sC;
  bool vec;

  BiasPreact(const void* bias_, int per_row_, float* P_, bf16* A_, int ldc_, long long sC_)
      : bias(static_cast<const bf16*>(bias_)), per_row(per_row_), P(P_), A(A_), ldc(ldc_),
        sC(sC_), vec(vec8(P_, A_, ldc_, sC_)) {}

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const size_t o = z * sC + (size_t)m * ldc + n;
    float p[8], a[8];
    for (int e = 0; e < cnt; ++e) {
      p[e] = v[e] + __bfloat162float(bias[per_row ? m : n + e]);
      if (A) a[e] = gelu_tanh(p[e]);
    }
    if (vec && cnt == 8) {
      store8(P + o, p);
      if (A) store8(A + o, a);
    } else {
      for (int e = 0; e < cnt; ++e) {
        P[o + e] = p[e];
        if (A) A[o + e] = __float2bfloat16(a[e]);
      }
    }
  }
};

// d = acc · gelu_tanh'(P), P the f32 pre-activation at the same place;
// G = bf16(d), and with keep P = d (in place, for the bias gradient).
struct GeluGrad {
  float* P;
  bf16* G;
  int ldc;
  long long sC;
  int keep;
  bool vec;

  GeluGrad(float* P_, bf16* G_, int ldc_, long long sC_, int keep_)
      : P(P_), G(G_), ldc(ldc_), sC(sC_), keep(keep_), vec(vec8(P_, G_, ldc_, sC_)) {}

  __device__ void operator()(long long z, int m, int n, const float* v, int cnt) const {
    const size_t o = z * sC + (size_t)m * ldc + n;
    float d[8];
    if (vec && cnt == 8) {
      load8(P + o, d);
    } else {
      for (int e = 0; e < cnt; ++e) d[e] = P[o + e];
    }
    for (int e = 0; e < cnt; ++e) d[e] = v[e] * gelu_tanh_grad(d[e]);
    if (vec && cnt == 8) {
      if (keep) store8(P + o, d);
      store8(G + o, d);
    } else {
      for (int e = 0; e < cnt; ++e) {
        if (keep) P[o + e] = d[e];
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
  bf16 *xn, *t, *dtp;
  float *tp, *dxn, *rs, *p1, *p2;
  LnScratch ln;
  int per, groups;
};

TokenWork token_work(char* base, size_t* bytes, int B, int N, int D, int TD, int sms) {
  Carver cv{base};
  TokenWork w;
  const size_t nd = (size_t)B * N * D, td = (size_t)B * TD * D;
  w.per = bf16gemm::images_per_group(B, TD, N, sms);  // dWt1 and dWt2 have the same tiles
  w.groups = bf16gemm::groups((long long)B * D, D, w.per);
  w.xn = cv.take<bf16>(nd);
  w.t = cv.take<bf16>(td);
  w.dtp = cv.take<bf16>(td);
  w.tp = cv.take<float>(td);
  w.dxn = cv.take<float>(nd);
  w.rs = cv.take<float>((size_t)B * TD);
  w.p1 = cv.take<float>((size_t)w.groups * TD * N);
  w.p2 = cv.take<float>((size_t)w.groups * N * TD);
  w.ln = ln_scratch(cv, B * N, D);
  if (bytes) *bytes = cv.bytes;
  return w;
}

// ---- channel backward --------------------------------------------------

struct ChanWork {
  bf16 *hn, *c, *dcp;
  float *cp, *dhn, *pcol, *pc1, *pc2;
  LnScratch ln;
  int slab, slabs;  // rows of a slab of the weight-gradient sums, their count
};

// Images per row slab of dWc1 (M×N = CD×D) and dWc2: whole images, about
// sms / tiles slabs for the output's `tiles` 192×192 tiles, so that the
// (slab, tile) pairs fill the card about once; at least one slab, at most
// one an image.
inline int slab_images(int B, int M, int N, int sms) {
  const int tiles = ((M + sm90::BM - 1) / sm90::BM) * ((N + sm90::BN - 1) / sm90::BN);
  const int g = std::max(1, std::min(B, sms / tiles));
  return (B + g - 1) / g;
}

// sms: the device's multiprocessor count (only the weight-gradient entry,
// wgt, uses it).
ChanWork chan_work(char* base, size_t* bytes, int B, int N, int D, int CD, bool wgt, int sms) {
  Carver cv{base};
  ChanWork w{};
  const size_t rows = (size_t)B * N;
  w.hn = cv.take<bf16>(rows * D);
  w.cp = cv.take<float>(rows * CD);
  w.dcp = cv.take<bf16>(rows * CD);
  if (wgt) {
    w.slab = slab_images(B, CD, D, sms) * N;
    w.slabs = bf16gemm::groups((long long)rows, w.slab, 1);
    w.c = cv.take<bf16>(rows * CD);
    w.pcol = cv.take<float>((size_t)col_groups((int)rows) * CD);
    w.pc1 = cv.take<float>((size_t)w.slabs * CD * D);
    w.pc2 = cv.take<float>((size_t)w.slabs * D * CD);
  } else {
    w.dhn = cv.take<float>(rows * D);
    w.ln = ln_scratch(cv, (int)rows, D);
  }
  if (bytes) *bytes = cv.bytes;
  return w;
}

// hn = bf16(LN2(h)); cp = hn·Wc1ᵀ + bc1 (f32, and c = bf16(act(cp)) where
// c is given); dcp = bf16((g·Wc2)·act'(cp)), with keep the f32 value in cp.
// Both products on the wgmma core; g·Wc2 reads Wc2 (D, CD) N-major.
cudaError_t chan_recompute(cudaStream_t s, const void* h, const void* g, const void* ln2w,
                           const void* ln2b, const void* bc1, const void* wc1, const void* wc2,
                           const ChanWork& w, int rows, int D, int CD, int keep) {
  BWD_CHECK(layer_norm(s, h, D, ln2w, ln2b, w.hn, rows, D));
  BWD_CHECK(sm90::gemm_tn(s, rows, CD, D, w.hn, D, wc1, D, BiasPreact(bc1, 0, w.cp, w.c, CD, 0)));
  BWD_CHECK((sm90::gemm_bf16<false, true>(s, 1, rows, CD, D, D, g, D, 0, wc2, CD, 0,
                                          GeluGrad(w.cp, w.dcp, CD, 0, keep))));
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
// (B, TD, D), c (B·N, CD).
extern "C" int mixer_fwd_with_h_bf16(const void* x, const void* ln1w, const void* ln1b,
                                     const void* wt1, const void* bt1, const void* wt2,
                                     const void* bt2, const void* ln2w, const void* ln2b,
                                     const void* wc1, const void* bc1, const void* wc2,
                                     const void* bc2, void* xn, void* t, void* c, void* h,
                                     void* out, int B, int N, int D, int TD, int CD,
                                     void* stream_ptr) {
  return mixer_forward(static_cast<cudaStream_t>(stream_ptr), x, ln1w, ln1b, wt1, bt1, wt2, bt2,
                       ln2w, ln2b, wc1, bc1, wc2, bc2, xn, t, h, c, out, B, N, D, TD, CD);
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
  const long long nd = (long long)N * D, td = (long long)TD * D, bd = (long long)B * D;
  // recompute: xn = bf16(LN1(x)); tp = Wt1·xn + bt1 (f32); t = bf16(act(tp))
  JMT_CHECK(layer_norm(s, x, D, ln1w, ln1b, w.xn, B * N, D));
  JMT_CHECK(gemm<false>(s, B, TD, D, N, wt1, N, 0, w.xn, D, nd,
                        BiasPreact(bt1, 1, w.tp, w.t, D, td)));
  // dWt2 = Σ_b dh_b·t_bᵀ
  JMT_CHECK((gemm_sum<false, true>(s, bd, D, w.per, N, TD, dh, D, nd, w.t, D, td,
                                  StoreF32(w.p2, TD, (long long)N * TD))));
  JMT_CHECK(sum_groups(s, w.p2, w.groups, (long long)N * TD, dwt2));
  // dtp = (Wt2ᵀ·dh)·act'(tp): f32 in tp, bf16 in dtp; dbt1 = Σ over images and columns
  JMT_CHECK((gemm_ex<true, false>(s, B, TD, D, N, wt2, TD, 0, dh, D, nd,
                                 GeluGrad(w.tp, w.dtp, D, td, 1))));
  row_sum_kernel<<<(B * TD + 7) / 8, 256, 0, s>>>(w.tp, B * TD, D, w.rs);
  JMT_CHECK(cudaGetLastError());
  JMT_CHECK(sum_groups(s, w.rs, B, TD, dbt1));
  // dWt1 = Σ_b dtp_b·xn_bᵀ
  JMT_CHECK((gemm_sum<false, true>(s, bd, D, w.per, TD, N, w.dtp, D, td, w.xn, D, nd,
                                  StoreF32(w.p1, N, (long long)TD * N))));
  JMT_CHECK(sum_groups(s, w.p1, w.groups, (long long)TD * N, dwt1));
  // dxn = Wt1ᵀ·dtp (f32); dx = bf16(dh + LN1_bwd(dxn)) and the LN1 gradients
  JMT_CHECK((gemm_ex<true, false>(s, B, N, D, TD, wt1, N, 0, w.dtp, D, td,
                                 StoreF32(w.dxn, D, nd))));
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
  JMT_CHECK(chan_recompute(s, h, g, ln2w, ln2b, bc1, wc1, wc2, w, rows, D, CD, 0));
  // dhn = dcp·Wc1 (f32, one K = CD product)
  JMT_CHECK(gemm<false>(s, 1, rows, D, CD, w.dcp, CD, 0, wc1, D, 0, StoreF32(w.dhn, D, 0)));
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
  JMT_CHECK(chan_recompute(s, h, g, ln2w, ln2b, bc1, wc1, wc2, w, rows, D, CD, 1));
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
// WMMA core), since it was loaded (gemm_sm90.cuh): the forward's two
// channel products, the channel data backward's two recompute products and
// the channel weight backward's four; -1 for another route.
extern "C" long long mixer_bwd_gemm_products(int route) { return sm90::products(route); }

extern "C" const char* mixer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
