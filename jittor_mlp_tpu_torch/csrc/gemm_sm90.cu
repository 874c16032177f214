// One channel product of the Mixer block on Hopper (sm_90a), with a plain C
// interface: the checking entry of gemm_sm90.cuh, so that a product can be
// held against its plain version and timed on its own, on either core.
//
// Replaces the channel half of the Pallas TPU kernel
// jittor_mlp_tpu/ops/pallas/mixer_block.py:157 fused_mixer_block, one
// product at a time: for A (M, K), B (N, K) and bias (N,), all bf16,
//   act 0:  C = bf16(gelu_tanh(A · Bᵀ + bias))          (GeluBias)
//   act 1:  C = bf16(R + (A · Bᵀ + bias)), R (M, N)     (ResidualBias)
// with f32 sums. What bounds it and what the design does about it: see
// gemm_sm90.cuh. Nothing on the serving or training path calls this entry;
// kernel 1 and the training forward reach the same core through
// mixer_forward.cuh.

#include "gemm_sm90.cuh"

using namespace jmt;

// All pointers are contiguous bf16 device buffers; r is read for act 1
// only. core: 0 the wgmma core where TMA's rules hold, else the WMMA core;
// 1 the wgmma core (an error where the rules do not hold); 2 the WMMA core.
// Returns a cudaError_t code (0 on success); cudaErrorInvalidValue for an
// unknown act or core.
extern "C" int gemm_tn_bf16(const void* a, const void* b, const void* bias, const void* r, void* c,
                            int M, int N, int K, int act, int core, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (core < 0 || core > 2) return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Core which = static_cast<sm90::Core>(core);
  if (act == 0)
    return static_cast<int>(
        sm90::gemm_tn(s, M, N, K, a, K, b, K, bf16gemm::gelu_bias(bias, 0, c, N, 0), which));
  if (act == 1)
    return static_cast<int>(sm90::gemm_tn(s, M, N, K, a, K, b, K,
                                          bf16gemm::residual_bias(bias, 0, r, c, N, 0), which));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Products this library launched on route 0 (the wgmma core) or 1 (the
// WMMA core), since it was loaded; -1 for another route.
extern "C" long long gemm_tn_products(int route) { return sm90::products(route); }

// The core's tile (rows, columns, K step), ring stages and dynamic shared
// memory in bytes: what = 0, 1, 2, 3, 4; -1 otherwise.
extern "C" long long gemm_sm90_config(int what) {
  const long long v[] = {sm90::BM, sm90::BN, sm90::BK, sm90::STAGES, sm90::SMEM_BYTES};
  return what >= 0 && what < 5 ? v[what] : -1;
}

extern "C" const char* gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
