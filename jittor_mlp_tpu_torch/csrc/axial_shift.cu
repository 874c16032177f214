// AS-MLP's zero-fill axial shift for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel jittor_mlp_tpu/ops/pallas/shift_kernel.py::
// _call (reached from axial_shift_pallas and _call_any_axis), and its custom
// VJP's backward. For x (B, H, W, C), channel-last and contiguous, and an
// axis a (1 = H, 2 = W):
//   group = ceil(C / shift),  g = c / group,  s = sign · (shift/2 − g)
//   out[b, .., p, .., c] = x[b, .., p + s, .., c]  where 0 ≤ p + s < n_a, else +0
// sign +1 is the forward shift; sign −1 is its gradient (the same shift with
// s negated). There may be fewer than `shift` groups (C = 16, shift 5: four
// groups, s = 2, 1, 0, −1), and the last group may be short (C = 20, shift 3:
// 7, 7, 6 channels).
//
// What bounds it on this card, and what the design does about it:
// - It is a pure copy: each input element read once, each output element
//   written once, 2·B·H·W·C·bytes in all. At AS-MLP-T's stage-1 shape
//   (256, 56, 56, 96) in bf16 that is 308 MB, 0.092 ms at 3.35 TB/s. Nothing
//   is computed, so the design only has to keep the memory traffic wide and
//   coalesced.
// - Each thread owns one 16-byte output vector (8 bf16 or 4 f32 channels of
//   one pixel); neighbouring threads own neighbouring channels, so a warp
//   reads and writes contiguous 512-byte runs. Where the whole vector lies in
//   one channel group it has one source offset, and the thread moves it with
//   one 16-byte load (or writes zeros). A vector that straddles a group
//   boundary (AS-MLP-T's groups are 20 channels, so 2 of every 12 bf16
//   vectors do) gathers its lanes one by one, each at its own offset.
// - Both axes shift in place in NHWC: along W the source is s·C elements
//   away, along H s·W·C. The TPU version transposes H and W around an axis-1
//   kernel; here no transpose is needed.
// - Where C is not a multiple of the vector width, or a pointer is not
//   16-byte aligned, every element is moved alone.
// The kernel copies bit patterns, so bf16 and f32 share one code path, and
// the output equals its plain twin bit for bit.

#include <algorithm>

#include "common.cuh"

namespace {

// How far along the axis channel c reads: s = sign · (shift/2 − c/group).
__device__ __forceinline__ int source_offset(int c, int group, int half, int sign) {
  return sign * (half - c / group);
}

template <typename T, int VEC>
__global__ void axial_shift_kernel(const T* __restrict__ x, T* __restrict__ out, long long items,
                                   int H, int W, int C, int group, int half, int axis, int sign) {
  const int per_pixel = C / VEC;
  const int n = axis == 1 ? H : W;
  const long long step = axis == 1 ? static_cast<long long>(W) * C : C;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < items;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(v % per_pixel) * VEC;
    const long long pixel = v / per_pixel;
    const int p = axis == 1 ? static_cast<int>((pixel / W) % H) : static_cast<int>(pixel % W);
    const long long o = v * VEC;  // the output's first element; the input's has the same layout
    union {
      uint4 u;
      T t[VEC];
    } val;
    if (VEC > 1 && c0 / group == (c0 + VEC - 1) / group) {  // one group: one offset
      const int s = source_offset(c0, group, half, sign);
      val.u = make_uint4(0, 0, 0, 0);
      if (p + s >= 0 && p + s < n) val.u = *reinterpret_cast<const uint4*>(x + o + s * step);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int s = source_offset(c0 + e, group, half, sign);
        val.t[e] = (p + s >= 0 && p + s < n) ? x[o + e + s * step] : T(0);
      }
    }
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(out + o) = val.u;
    } else {
      out[o] = val.t[0];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int H, int W, int C, int group, int half,
                   int axis, int sign, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long n = static_cast<long long>(B) * H * W * C;
  const bool vector = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long items = vector ? n / VEC : n;
  const int threads = 256;
  // a grid-stride loop: enough blocks to fill every SM many times over
  const long long blocks = std::min<long long>((items + threads - 1) / threads, 1 << 16);
  const T* src = static_cast<const T*>(x);
  T* dst = static_cast<T*>(out);
  if (vector) {
    axial_shift_kernel<T, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        src, dst, items, H, W, C, group, half, axis, sign);
  } else {
    axial_shift_kernel<T, 1><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        src, dst, items, H, W, C, group, half, axis, sign);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous device buffers of B·H·W·C elements of elem_bytes each
// (2: bf16, 4: f32). axis 1 (H) or 2 (W); sign +1 (forward) or −1 (the
// gradient). Returns a cudaError_t code (0 on success).
extern "C" int axial_shift(const void* x, void* out, int B, int H, int W, int C, int shift,
                           int axis, int sign, int elem_bytes, void* stream_ptr) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || shift <= 0 || (axis != 1 && axis != 2) ||
      (sign != 1 && sign != -1) || (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = (C + shift - 1) / shift;
  const int half = shift / 2;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      elem_bytes == 2
          ? launch<uint16_t>(x, out, B, H, W, C, group, half, axis, sign, stream)
          : launch<uint32_t>(x, out, B, H, W, C, group, half, axis, sign, stream);
  return static_cast<int>(err);
}

extern "C" const char* shift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
