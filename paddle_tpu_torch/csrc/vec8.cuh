// Device helpers shared by the port's streaming kernels (fused_update.cu,
// layer_norm.cu, softmax_xent.cu): a vector of 8 elements (16 bytes of
// bfloat16, 32 of float32), the float32 conversions each rounds with, and
// float32 loads and stores of 8 consecutive elements of a row that move
// whole vectors where the caller says the pointer is 16-byte aligned.
//
// Included by each source; _build.py hashes the headers of csrc/ with
// each source, so an edit here rebuilds every library.

#pragma once

#include <cuda_bf16.h>

namespace {

constexpr int kVec = 8;  // elements a thread loads at once

template <typename T>
struct alignas(16) Vec8 {
  T v[kVec];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// v[i] = ptr[c + i] for c + i < n, else 0; vector loads when `aligned`
// (ptr 16-byte aligned) and the whole vector lies inside the row
template <typename T, typename I>
__device__ __forceinline__ void load8(const T* __restrict__ ptr, I c, I n,
                                      bool aligned, float (&v)[kVec]) {
  if (aligned && c + kVec <= n) {
    const Vec8<T> t = *reinterpret_cast<const Vec8<T>*>(ptr + c);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = to_f32(t.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = c + i < n ? to_f32(ptr[c + i]) : 0.f;
  }
}

// ptr[c + i] = v[i] rounded to T, for c + i < n
template <typename T, typename I>
__device__ __forceinline__ void store8(T* __restrict__ ptr, I c, I n,
                                       bool aligned, const float (&v)[kVec]) {
  if (aligned && c + kVec <= n) {
    Vec8<T> t;
#pragma unroll
    for (int i = 0; i < kVec; ++i) t.v[i] = from_f32<T>(v[i]);
    *reinterpret_cast<Vec8<T>*>(ptr + c) = t;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (c + i < n) ptr[c + i] = from_f32<T>(v[i]);
  }
}

}  // namespace
