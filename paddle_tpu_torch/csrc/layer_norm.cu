// Row LayerNorm for NVIDIA Hopper (sm_90a), CUDA C++: kernels #5 and #6.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/layer_norm.py:
//   ln_fwd_kernel                      <- `_fwd_kernel` (pallas_call in
//                                         `_ln_fwd_impl`)
//   ln_bwd_kernel + ln_finalize_kernel <- `_bwd_kernel` (pallas_call in
//                                         `_ln_bwd`)
//
// Over each row x of [R, C] (float32 or bfloat16; weight and bias [C],
// float32 or bfloat16), all sums in float32:
//   forward:  mu = mean(x), var = mean((x - mu)^2) (centred, a second pass
//             over the row, not E[x^2] - mu^2), rstd = rsqrt(var + eps),
//             y = (x - mu) * rstd * w + b rounded once to x's dtype; mu and
//             rstd are saved as float32 [R].
//   backward: xhat = (x - mu) * rstd, wdy = w * dy, c1 = mean(xhat * wdy),
//             c2 = mean(wdy), dx = (wdy - xhat * c1 - c2) * rstd rounded to
//             x's dtype; dw = sum over rows of dy * xhat and db = sum of dy,
//             rounded once to w's dtype.
//
// What bounds it on the card: device-memory bytes. At GPT-medium's
// [8192, 1024] bf16 the forward reads x and writes y (33.6 MB, 10 us at
// 3.35 TB/s) and the backward reads x and dy and writes dx (50.3 MB,
// 15 us), with about 10 float32 operations an element. What the design
// does about it: 16-byte vector loads and stores (8 bf16, or 2 x 4 f32) on
// rows whose start is 16-byte aligned, scalar ones otherwise; every
// element of x is read from device memory once by the forward, which keeps
// its row in registers (up to 4 vectors a thread, C <= 8192 at 256
// threads; wider rows read the rest again from the cache).
//
// Against the TPU kernel's sequential grid: the Pallas backward adds dw
// and db into its output block over a grid that the TPU runs in order. A
// CUDA grid has no order, so each backward block owns a strip of
// consecutive rows, keeps its strip's dw/db sums in shared memory (each
// thread its own columns, laid out so that a warp's 32 threads hit 32
// banks) and writes float32 partials [2][n_strips][C]; ln_finalize_kernel
// then adds the strips of each column in strip order and rounds once. The
// sums are deterministic and take no atomics (the finalize pattern of
// fused_update.cu). Row sums are deterministic too: xor-shuffle warp sums,
// then the warps' partials in order.
//
// nvcc contracts a*b + c into FMAs, so results differ from the plain
// PyTorch twins (ops/kernels/layer_norm.py) by a few float32 ulps.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes. Each entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "vec8.cuh"

namespace {

constexpr int kMaxThreads = 256;    // threads of a row block
constexpr int kCache = 4;           // vectors a forward thread keeps
constexpr int kMaxCols = 16384;     // widest row (backward shared memory)
constexpr int kFinalizeCols = 32;   // columns of a finalize block
constexpr int kFinalizeGroups = 32; // strip groups of a finalize block
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kRedBytes = 2 * kMaxThreads / 32 * sizeof(float);

// (a, b) summed over the block, the same in every thread: xor-shuffle
// warp sums, then the warps' sums in warp order. blockDim.x is a multiple
// of 32; red holds kRedBytes.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  const int nw = blockDim.x >> 5;
  __syncthreads();  // red is free: every thread has read the last sums
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[kMaxThreads / 32 + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int w = 0; w < nw; ++w) {
    s.x += red[w];
    s.y += red[kMaxThreads / 32 + w];
  }
  return s;
}

// One block per row. Thread t owns the vectors t, t + blockDim.x, ... of
// the row; the first kCache stay in registers between the three passes.
template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    ln_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                  const TW* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mu, float* __restrict__ rstd, int C,
                  float eps, int aligned_x, int aligned_w) {
  __shared__ float red[kRedBytes / sizeof(float)];
  const int step = blockDim.x * kVec;
  const int c0 = threadIdx.x * kVec;
  const long long off = static_cast<long long>(blockIdx.x) * C;
  const T* xr = x + off;
  float v[kCache][kVec];

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int c = c0 + k * step;
    if (c < C) {
      load8(xr, c, C, aligned_x, v[k]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) s += v[k][i];
    }
  }
  for (int c = c0 + kCache * step; c < C; c += step) {
    float t[kVec];
    load8(xr, c, C, aligned_x, t);
#pragma unroll
    for (int i = 0; i < kVec; ++i) s += t[i];
  }
  const float mean = block_sum2(s, 0.f, red).x / C;

  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int c = c0 + k * step;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float d = c + i < C ? v[k][i] - mean : 0.f;
        q += d * d;
      }
    }
  }
  for (int c = c0 + kCache * step; c < C; c += step) {
    float t[kVec];
    load8(xr, c, C, aligned_x, t);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float d = c + i < C ? t[i] - mean : 0.f;
      q += d * d;
    }
  }
  const float rs = rsqrtf(block_sum2(q, 0.f, red).x / C + eps);

  T* yr = y + off;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int c = c0 + k * step;
    if (c < C) {
      float wv[kVec], bv[kVec], o[kVec];
      load8(w, c, C, aligned_w, wv);
      load8(b, c, C, aligned_w, bv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = (v[k][i] - mean) * rs * wv[i] + bv[i];
      store8(yr, c, C, aligned_x, o);
    }
  }
  for (int c = c0 + kCache * step; c < C; c += step) {
    float t[kVec], wv[kVec], bv[kVec], o[kVec];
    load8(xr, c, C, aligned_x, t);
    load8(w, c, C, aligned_w, wv);
    load8(b, c, C, aligned_w, bv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) o[i] = (t[i] - mean) * rs * wv[i] + bv[i];
    store8(yr, c, C, aligned_x, o);
  }
  if (threadIdx.x == 0) {
    mu[blockIdx.x] = mean;
    rstd[blockIdx.x] = rs;
  }
}

// One block per strip of rows_per_strip rows. Shared memory holds w and
// the strip's dw and db sums as float32, element i of vector j at
// [i * nvec + j]: thread t owns the vectors t, t + blockDim.x, ... in
// every loop, so no thread reads another's columns.
template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    ln_bwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ mu,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ partials, int R,
                  int C, int rows_per_strip, int aligned_x, int aligned_w) {
  extern __shared__ float smem[];
  __shared__ float red[kRedBytes / sizeof(float)];
  const int nvec = (C + kVec - 1) / kVec;
  float* ws = smem;
  float* dws = smem + nvec * kVec;
  float* dbs = dws + nvec * kVec;
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    float t[kVec];
    load8(w, j * kVec, C, aligned_w, t);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      ws[i * nvec + j] = t[i];
      dws[i * nvec + j] = 0.f;
      dbs[i * nvec + j] = 0.f;
    }
  }
  const int r0 = blockIdx.x * rows_per_strip;
  const int r1 = min(R, r0 + rows_per_strip);
  for (int r = r0; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * C;
    const float m = mu[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
      float xv[kVec], dv[kVec];
      load8(x + off, j * kVec, C, aligned_x, xv);
      load8(dy + off, j * kVec, C, aligned_x, dv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        // past the row's end dv is 0 and so wdy, and nothing is added
        const float xh = (xv[i] - m) * rs;
        const float wdy = dv[i] * ws[i * nvec + j];
        s1 += xh * wdy;
        s2 += wdy;
        dws[i * nvec + j] += dv[i] * xh;
        dbs[i * nvec + j] += dv[i];
      }
    }
    const float2 cs = block_sum2(s1, s2, red);
    const float c1 = cs.x / C, c2 = cs.y / C;
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
      float xv[kVec], dv[kVec], o[kVec];
      load8(x + off, j * kVec, C, aligned_x, xv);
      load8(dy + off, j * kVec, C, aligned_x, dv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xh = (xv[i] - m) * rs;
        const float wdy = dv[i] * ws[i * nvec + j];
        o[i] = (wdy - xh * c1 - c2) * rs;
      }
      store8(dx + off, j * kVec, C, aligned_x, o);
    }
  }
  float* pw = partials + static_cast<long long>(blockIdx.x) * C;
  float* pb = partials + static_cast<long long>(gridDim.x + blockIdx.x) * C;
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = j * kVec + i;
      if (c < C) {
        pw[c] = dws[i * nvec + j];
        pb[c] = dbs[i * nvec + j];
      }
    }
  }
}

// dw[c], db[c] = the strips' partials of column c added in strip order:
// thread (g, col) adds the strips g, g + 32, ... in order, then thread
// (0, col) adds the 32 groups in order and rounds once to w's dtype.
template <typename TW>
__global__ void __launch_bounds__(kFinalizeCols * kFinalizeGroups)
    ln_finalize_kernel(const float* __restrict__ partials, int n_strips,
                       int C, TW* __restrict__ dw, TW* __restrict__ db) {
  __shared__ float sw[kFinalizeGroups][kFinalizeCols + 1];
  __shared__ float sb[kFinalizeGroups][kFinalizeCols + 1];
  const int col = threadIdx.x % kFinalizeCols;
  const int g = threadIdx.x / kFinalizeCols;
  const int c = blockIdx.x * kFinalizeCols + col;
  float aw = 0.f, ab = 0.f;
  if (c < C) {
    for (int s = g; s < n_strips; s += kFinalizeGroups) {
      aw += partials[static_cast<long long>(s) * C + c];
      ab += partials[static_cast<long long>(n_strips + s) * C + c];
    }
  }
  sw[g][col] = aw;
  sb[g][col] = ab;
  __syncthreads();
  if (g == 0 && c < C) {
    float tw = 0.f, tb = 0.f;
    for (int k = 0; k < kFinalizeGroups; ++k) {
      tw += sw[k][col];
      tb += sb[k][col];
    }
    dw[c] = from_f32<TW>(tw);
    db[c] = from_f32<TW>(tb);
  }
}

// threads of a row block: one vector each up to kMaxThreads, a multiple
// of the warp
int row_threads(int C) {
  const int vecs = (C + kVec - 1) / kVec;
  const int t = (vecs + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename T, typename TW>
int fwd(const void* x, const void* w, const void* b, void* y, float* mu,
        float* rstd, int R, int C, float eps, int aligned_x, int aligned_w,
        cudaStream_t s) {
  ln_fwd_kernel<T, TW><<<R, row_threads(C), 0, s>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w),
      static_cast<const TW*>(b), static_cast<T*>(y), mu, rstd, C, eps,
      aligned_x, aligned_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int bwd(const void* x, const void* w, const float* mu, const float* rstd,
        const void* dy, void* dx, float* partials, void* dw, void* db,
        int R, int C, int rows_per_strip, int n_strips, int aligned_x,
        int aligned_w, cudaStream_t s) {
  const size_t smem = 3 * static_cast<size_t>((C + kVec - 1) / kVec) *
                      kVec * sizeof(float);
  // a block may hold 48 KB of shared memory, the static part included,
  // unless the kernel opts in to more
  if (smem + kRedBytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_kernel<T, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ln_bwd_kernel<T, TW><<<n_strips, row_threads(C), smem, s>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), mu, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), partials, R, C,
      rows_per_strip, aligned_x, aligned_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_finalize_kernel<TW>
      <<<(C + kFinalizeCols - 1) / kFinalizeCols,
         kFinalizeCols * kFinalizeGroups, 0, s>>>(
          partials, n_strips, C, static_cast<TW*>(dw), static_cast<TW*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the widest row the kernels take
int layer_norm_max_cols() { return kMaxCols; }

// dtypes: 0 float32, 1 bfloat16 (x_dtype for x, y; w_dtype for w, b).
// aligned_x: x and y start 16-byte aligned and a row is a multiple of 16
// bytes; aligned_w: w and b start 16-byte aligned.
int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                   float* mu, float* rstd, int R, int C, float eps,
                   int x_dtype, int w_dtype, int aligned_x, int aligned_w,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, mu, rstd, R, C, eps,
                                             aligned_x, aligned_w, s);
  if (x_dtype == 1)
    return fwd<__nv_bfloat16, float>(x, w, b, y, mu, rstd, R, C, eps,
                                     aligned_x, aligned_w, s);
  if (w_dtype == 1)
    return fwd<float, __nv_bfloat16>(x, w, b, y, mu, rstd, R, C, eps,
                                     aligned_x, aligned_w, s);
  return fwd<float, float>(x, w, b, y, mu, rstd, R, C, eps, aligned_x,
                           aligned_w, s);
}

// partials: float32 [2][n_strips][C] scratch; strip k holds the rows
// [k * rows_per_strip, (k + 1) * rows_per_strip) that are < R. dx in x's
// dtype; dw, db in w's dtype. aligned_x covers x, dy and dx.
int layer_norm_bwd(const void* x, const void* w, const float* mu,
                   const float* rstd, const void* dy, void* dx,
                   float* partials, void* dw, void* db, int R, int C,
                   int rows_per_strip, int n_strips, int x_dtype,
                   int w_dtype, int aligned_x, int aligned_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    return bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, mu, rstd, dy, dx, partials, dw, db, R, C, rows_per_strip,
        n_strips, aligned_x, aligned_w, s);
  if (x_dtype == 1)
    return bwd<__nv_bfloat16, float>(x, w, mu, rstd, dy, dx, partials, dw,
                                     db, R, C, rows_per_strip, n_strips,
                                     aligned_x, aligned_w, s);
  if (w_dtype == 1)
    return bwd<float, __nv_bfloat16>(x, w, mu, rstd, dy, dx, partials, dw,
                                     db, R, C, rows_per_strip, n_strips,
                                     aligned_x, aligned_w, s);
  return bwd<float, float>(x, w, mu, rstd, dy, dx, partials, dw, db, R, C,
                           rows_per_strip, n_strips, aligned_x, aligned_w, s);
}

}  // extern "C"
