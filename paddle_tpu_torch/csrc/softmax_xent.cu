// Hard-label softmax cross-entropy for NVIDIA Hopper (sm_90a), CUDA C++:
// kernels #7 and #8.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/softmax_xent.py:
//   xent_fwd_kernel <- `_fwd_kernel` (pallas_call in `_fwd_impl`)
//   xent_bwd_kernel <- `_bwd_kernel` (pallas_call in `_bwd`)
//
// Over each row x of the logits [N, V] (float32 or bfloat16) with an int32
// label, in float32:
//   forward:  lse = m + log(max(l, 1e-30)) from the row's running max m
//             and sum l of exp(x - m); loss = lse - x[label], where a label
//             outside [0, V) picks nothing (loss = lse); loss and lse are
//             written as float32 [N]. Nothing of size [N, V] is written.
//   backward: dx = (exp(x - lse) - (col == label)) * dloss, rounded once to
//             x's dtype.
//
// What bounds it on the card: device-memory bytes. At GPT-medium's
// training shape, [8192, 50304] bf16 logits (824 MB), the forward reads
// them once (0.246 ms at 3.35 TB/s) and the backward reads them and
// writes dx (0.492 ms); each does a few float32 operations and one or two
// exponentials an element. What the design does about it: 16-byte vector
// loads and stores (8 bf16, or 2 x 4 f32) where a row starts 16-byte
// aligned (50304 bf16 do; 50257 do not, and take scalar loads), and the
// forward keeps its online (m, l) in registers so the logits are read
// once and no log-probabilities are materialised.
//
// Against the TPU kernel's grid: the Pallas forward walks vocab blocks in
// order on one core and carries (m, l, picked) in scratch memory. Here one
// block of 256 threads owns a row: each thread keeps its own online (m, l)
// over the vectors t, t + 256, ... (one rescale a vector of 8), the warp
// merges them by xor shuffles and thread 0 merges the warps in order, so
// the result is deterministic. The label's logit is read directly. The
// backward is elementwise: block (row, tile) computes 2048 columns.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes
// (ops/kernels/softmax_xent.py). Each entry point launches on the stream
// it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "vec8.cuh"

namespace {

constexpr int kThreads = 256;    // threads of a block
constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// (m, l) <- the online-softmax merge of (m, l) and (mo, lo)
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse,
                    long long V, int aligned) {
  __shared__ float red_m[kThreads / 32], red_l[kThreads / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * V;
  float m = kNegInf, l = 0.f;
  for (long long c = threadIdx.x * kVec; c < V; c += kThreads * kVec) {
    float v[kVec];
    load8(xr, c, V, aligned, v);
    const long long nv = V - c;  // the vector's elements inside the row
    float vm = kNegInf;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < nv) vm = fmaxf(vm, v[i]);
    const float mn = fmaxf(m, vm);
    float add = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < nv) add += expf(v[i] - mn);
    l = l * expf(m - mn) + add;
    m = mn;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(kFull, m, o);
    const float lo = __shfl_xor_sync(kFull, l, o);
    merge(m, l, mo, lo);
  }
  if ((threadIdx.x & 31) == 0) {
    red_m[threadIdx.x >> 5] = m;
    red_l[threadIdx.x >> 5] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = red_m[0];
    l = red_l[0];
    for (int w = 1; w < kThreads / 32; ++w) merge(m, l, red_m[w], red_l[w]);
    const float s = m + logf(fmaxf(l, 1e-30f));
    const int lab = labels[blockIdx.x];
    const float picked = lab >= 0 && lab < V ? to_f32(xr[lab]) : 0.f;
    loss[blockIdx.x] = s - picked;
    lse[blockIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ dloss, T* __restrict__ dx,
                    long long V, int aligned) {
  const long long c =
      (static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x) * kVec;
  if (c >= V) return;
  const long long off = static_cast<long long>(blockIdx.x) * V;
  const float s = lse[blockIdx.x], d = dloss[blockIdx.x];
  const long long lab = labels[blockIdx.x];
  float v[kVec], o[kVec];
  load8(x + off, c, V, aligned, v);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    o[i] = (expf(v[i] - s) - (c + i == lab ? 1.f : 0.f)) * d;
  store8(dx + off, c, V, aligned, o);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. aligned: x starts 16-byte aligned and a
// row of V elements is a multiple of 16 bytes. grid: N blocks.
int softmax_xent_fwd(const void* x, const int* labels, float* loss,
                     float* lse, long long N, long long V, int dtype,
                     int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    xent_fwd_kernel<__nv_bfloat16><<<N, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), labels, loss, lse, V, aligned);
  else
    xent_fwd_kernel<float><<<N, kThreads, 0, s>>>(
        static_cast<const float*>(x), labels, loss, lse, V, aligned);
  return static_cast<int>(cudaGetLastError());
}

// grid: N x ceil(V / 2048) blocks (the wrapper keeps the second below
// 65536); dx in x's dtype, aligned as x.
int softmax_xent_bwd(const void* x, const int* labels, const float* lse,
                     const float* dloss, void* dx, long long N, long long V,
                     int dtype, int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(N),
                  static_cast<unsigned>((V + kThreads * kVec - 1) /
                                        (kThreads * kVec)));
  if (dtype == 1)
    xent_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), labels, lse, dloss,
        static_cast<__nv_bfloat16*>(dx), V, aligned);
  else
    xent_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), labels, lse, dloss,
        static_cast<float*>(dx), V, aligned);
  return static_cast<int>(cudaGetLastError());
}

// columns one backward block covers
int softmax_xent_bwd_tile() { return kThreads * kVec; }

}  // extern "C"
