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
//   forward:  mu = mean(x), var = mean((x - mu)^2) (centred, a second sum
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
// 15 us), with about 10 float32 operations an element. The time a row
// takes is mostly the latency of its loads, so what counts is how many
// bytes are in flight on each SM.
//
// What the design does about it:
// - A row belongs to a group of WPR warps (one warp up to 1024 columns)
//   and stays in its lanes' registers, as loaded (bf16 packed) between
//   the passes over it: lane l of warp v of the group owns the 16-byte
//   vectors (k * WPR + v) * 32 + l, k < VPL, so a warp's loads are
//   contiguous. Each element is read from device memory once; the row
//   sums are xor-shuffle trees (every lane gets the same bits), crossing
//   warps once a sum through shared memory.
// - The rows reach the registers through a ring of STAGES rows a group
//   in shared memory, filled by cp.async: a lane copies its own vectors
//   of the rows ahead and reads back only those (so no barrier), and the
//   bytes in flight cost no registers. STAGES = 1 loads straight into
//   registers, as does any call whose rows are not 16-byte aligned.
// - w and b are staged in shared memory once a block, while the first
//   rows' copies fly, and read from there (opaque loads, so that the
//   compiler does not hold them in float32 registers for every row).
// - A block holds G = warps / WPR groups and takes a strip of
//   consecutive rows, group g its rows g, g + G, ..., all groups in step
//   (a block-wide barrier joins the warps of a row's sums); the grid is
//   what the card keeps resident (measured occupancy, shared memory
//   carved out to the most), the rows spread evenly (the wrapper's
//   _plan).
// - Backward dw/db: each thread adds dy * xhat and dy of its own columns
//   in float32 registers over every row its group takes; the block's
//   groups combine theirs in shared memory in group order and the block
//   writes one partial row ([2][n_strips][C] float32, one a strip, a few
//   hundred strips); ln_finalize_kernel then adds each column's strips in
//   strip order and rounds once to w's dtype, launched as a programmatic
//   dependent so that its launch overlaps the backward's last blocks. No
//   float atomics: the same inputs give the same bits.
// - Rows wider than the backward's registers hold (C > 8192) read x and
//   dy twice from the cache instead (STAGES = 0).
//
// Against the TPU kernel's sequential grid: the Pallas backward adds dw
// and db into its output block over a grid that the TPU runs in order; a
// CUDA grid has no order, hence the strips and their ordered sum.
//
// nvcc contracts a*b + c into FMAs, so results differ from the plain
// PyTorch twins (ops/kernels/layer_norm.py) by a few float32 ulps.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes. Each entry point
// launches on the stream it is given, allocates nothing, and returns its
// launches' cudaError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "vec8.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;     // a block: at most 16 warps
constexpr int kMaxCols = 16384;      // widest row
constexpr int kFinalizeCols = 32;    // columns of a finalize block
constexpr int kFinalizeGroups = 32;  // strip groups of a finalize block
constexpr unsigned kFull = 0xffffffffu;
// A block of rows of up to 8 warps takes up to 8 warps, and the compiler
// keeps registers for kMinBlocks of them on an SM (at 3, 65536 / (3 *
// 256) = 85 registers a thread: the backward spills); a wider row takes a
// block of its own.
constexpr int kMinBlocks = 1;
__host__ __device__ constexpr int block_cap(int wpr) {
  return wpr > 8 ? wpr * kWarp : 8 * kWarp;
}
// The finalize launches as a programmatic dependent of the backward
// kernel: its blocks are placed as the backward's retire and wait for
// its memory (griddepcontrol), so the launch's latency overlaps it.
constexpr int kFinalizeEarly = 1;

// v.v[i] = ptr[c + i] for c + i < n, else 0, kept in T
template <typename T>
__device__ __forceinline__ Vec8<T> load_raw(const T* __restrict__ ptr, int c,
                                            int n, bool aligned) {
  Vec8<T> t;
  if (aligned && c + kVec <= n) {
    t = *reinterpret_cast<const Vec8<T>*>(ptr + c);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      t.v[i] = c + i < n ? ptr[c + i] : from_f32<T>(0.f);
  }
  return t;
}

// until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
  return a;
}

// (a, b) summed over the WPR warps of a group, the same bits in every
// thread: warp trees, then the warps' sums in warp order through red
// (this group's WPR slots of one of two buffers, taken in turn, so one
// barrier a sum). Every thread of the block calls it (block-wide
// barrier) when WPR > 1.
template <int WPR>
__device__ __forceinline__ float2 group_sum2(float a, float b, float2* red,
                                             int v) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (WPR == 1) {
    return make_float2(a, b);
  } else {
    if ((threadIdx.x & (kWarp - 1)) == 0) red[v] = make_float2(a, b);
    __syncthreads();
    float2 s = red[0];
#pragma unroll
    for (int u = 1; u < WPR; ++u) {
      s.x += red[u].x;
      s.y += red[u].y;
    }
    return s;
  }
}

// first column of vector k of lane `lane` of warp v of a group
template <int WPR>
__device__ __forceinline__ int col_of(int k, int v, int lane) {
  return ((k * WPR + v) * kWarp + lane) * kVec;
}

// A vector of shared memory, read by an opaque load: the compiler may
// not hoist it out of the row loop (which would hold w and b in
// registers, as float32, for every row).
template <typename T>
__device__ __forceinline__ Vec8<T> lds(const Vec8<T>* p) {
  union {
    Vec8<T> v;
    unsigned u[sizeof(Vec8<T>) / 4];
  } t;
  const unsigned a = smem_u32(p);
#pragma unroll
  for (int h = 0; h < static_cast<int>(sizeof(Vec8<T>)) / 16; ++h)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(t.u[4 * h]), "=r"(t.u[4 * h + 1]),
                   "=r"(t.u[4 * h + 2]), "=r"(t.u[4 * h + 3])
                 : "r"(a + 16 * h));
  return t.v;
}

// Makes a row's packed bf16 words opaque to the compiler, so that it
// converts them again in the next pass instead of keeping their float32
// values (twice the registers) from the last one.
template <typename T>
__device__ __forceinline__ void opaque(Vec8<T>& v) {
  if constexpr (sizeof(T) == 2) {
    union {
      Vec8<T> v;
      unsigned u[4];
    } t;
    t.v = v;
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(t.u[i]));
    v = t.v;
  }
}

// w (and b) as loaded into shared memory, vector j at j, zero past C
template <typename TW>
__device__ __forceinline__ void stage_w(Vec8<TW>* dst,
                                        const TW* __restrict__ src, int C,
                                        bool aligned) {
  for (int j = threadIdx.x; j * kVec < C; j += blockDim.x)
    dst[j] = load_raw(src, j * kVec, C, aligned);
}

// This lane's vectors of one row (zero past C): into its slots of a
// ring stage by cp.async (the row 16-byte aligned), or, with ring ==
// nullptr, into v (16-byte loads where `aligned`).
template <typename T, int VPL, int WPR>
__device__ __forceinline__ void fetch_row(const T* __restrict__ row, int C,
                                          bool live, bool aligned,
                                          Vec8<T>* ring, Vec8<T> (&v)[VPL],
                                          int w, int lane) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = col_of<WPR>(k, w, lane);
    if (ring) {
      const unsigned dst = smem_u32(ring + (k * WPR + w) * kWarp + lane);
      // 16 bytes: 8 bf16, or 4 of the vector's 8 float32
#pragma unroll
      for (int h = 0; h < static_cast<int>(sizeof(Vec8<T>)) / 16; ++h) {
        const int e = c + h * 16 / static_cast<int>(sizeof(T));
        const bool ok = live && e < C;
        cp_async16(dst + 16 * h, ok ? row + e : row, ok);
      }
    } else if (live) {
      v[k] = load_raw(row, c, C, aligned);
    }
  }
}

// One block takes rows [blockIdx.x * rows_per_block, ...) below R, a
// multiple of G; its group g the rows g, g + G, ... of them. Dynamic
// shared memory (smem_bytes): w and b as loaded, then the groups' rings
// of STAGES rows.
template <typename T, typename TW, int VPL, int WPR, int STAGES>
__global__ void __launch_bounds__(block_cap(WPR), WPR > 8 ? 1 : kMinBlocks)
    ln_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                  const TW* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mu, float* __restrict__ rstd, int R,
                  int C, int rows_per_block, float eps, int aligned_x,
                  int aligned_w) {
  static_assert(STAGES >= 1, "the forward holds its rows");
  extern __shared__ float4 smem[];
  __shared__ float2 red[2][kMaxThreads / kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int G = blockDim.x / (WPR * kWarp);
  const int g = warp / WPR, v = warp % WPR;
  const int nvec = (C + kVec - 1) / kVec;
  const int nslot = WPR * kWarp * VPL;  // vectors of a row
  Vec8<TW>* ws = reinterpret_cast<Vec8<TW>*>(smem);
  Vec8<TW>* bs = ws + nvec;
  Vec8<T>* ring = reinterpret_cast<Vec8<T>*>(bs + nvec) + g * STAGES * nslot;
  const bool use_ring = STAGES > 1 && aligned_x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(static_cast<long long>(R), r0 + rows_per_block);
  const int n_iter = rows_per_block / G;
  Vec8<T> xv[VPL];
  auto row_of = [&](int j) { return r0 + g + static_cast<long long>(j) * G; };
  // row j into ring stage j % STAGES
  auto fetch = [&](int j) {
    const long long r = row_of(j);
    fetch_row<T, VPL, WPR>(x + (r < r1 ? r : 0) * C, C, r < r1, true,
                           ring + (j % STAGES) * nslot, xv, v, lane);
    cp_async_commit();
  };
  if (use_ring) {
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) fetch(j);
  }
  stage_w(ws, w, C, aligned_w);
  stage_w(bs, b, C, aligned_w);
  __syncthreads();
  for (int j = 0; j < n_iter; ++j) {
    const long long r = row_of(j);
    const bool live = r < r1;
    if (use_ring) {
      fetch(j + STAGES - 1);  // into the stage row j - 1 left
      cp_async_wait<STAGES - 1>();
      const Vec8<T>* slot = ring + (j % STAGES) * nslot + v * kWarp + lane;
#pragma unroll
      for (int k = 0; k < VPL; ++k) xv[k] = slot[k * WPR * kWarp];
    } else {
      fetch_row<T, VPL, WPR>(x + (live ? r : 0) * C, C, live, aligned_x,
                             nullptr, xv, v, lane);
    }
    float s = 0.f;
    if (live) {
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int i = 0; i < kVec; ++i) s += to_f32(xv[k].v[i]);
    }
    const float mean = group_sum2<WPR>(s, 0.f, red[0] + g * WPR, v).x / C;
    float q = 0.f;
    if (live) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        opaque(xv[k]);
        const int c = col_of<WPR>(k, v, lane);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = c + i < C ? to_f32(xv[k].v[i]) - mean : 0.f;
          q += d * d;
        }
      }
    }
    const float rs =
        rsqrtf(group_sum2<WPR>(q, 0.f, red[1] + g * WPR, v).x / C + eps);
    if (!live) continue;
    T* yr = y + r * C;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = col_of<WPR>(k, v, lane);
      if (c >= C) continue;
      opaque(xv[k]);
      const Vec8<TW> wk = lds(ws + c / kVec), bk = lds(bs + c / kVec);
      float o[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        o[i] = (to_f32(xv[k].v[i]) - mean) * rs * to_f32(wk.v[i]) +
               to_f32(bk.v[i]);
      store8(yr, c, C, static_cast<bool>(aligned_x), o);
    }
    if (v == 0 && lane == 0) {
      mu[r] = mean;
      rstd[r] = rs;
    }
  }
  if (use_ring) cp_async_wait<0>();
}

// One block a strip of rows_per_block consecutive rows, its groups
// taking them as the forward's do. STAGES >= 1: x and dy held in
// registers between the row sums and dx, fed as the forward's x is, with
// each row's mean and rstd copied beside them; STAGES = 0 reads x and
// dy twice from the cache. Dynamic shared memory (smem_bytes): w as
// loaded, the rings (x and dy of STAGES rows a group, then mean and rstd
// of STAGES rows a thread), then, with more than one group, the groups'
// dw/db combine.
template <typename T, typename TW, int VPL, int WPR, int STAGES>
__global__ void __launch_bounds__(block_cap(WPR), WPR > 8 ? 1 : kMinBlocks)
    ln_bwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ mu,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part, int R, int C,
                  int rows_per_block, int aligned_x, int aligned_w) {
  constexpr int kHeld = STAGES > 0 ? VPL : 1;  // vectors of a held row
  constexpr int kRing = STAGES > 1 ? STAGES : 0;
  extern __shared__ float4 smem[];
  __shared__ float2 red[2][kMaxThreads / kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int G = blockDim.x / (WPR * kWarp);
  const int g = warp / WPR, v = warp % WPR;
  const int nvec = (C + kVec - 1) / kVec;
  const int nslot = WPR * kWarp * VPL;  // vectors of a row group
  Vec8<TW>* ws = reinterpret_cast<Vec8<TW>*>(smem);
  Vec8<T>* rings = reinterpret_cast<Vec8<T>*>(ws + nvec);
  Vec8<T>* ring = rings + g * kRing * 2 * nslot;
  float2* mr = reinterpret_cast<float2*>(rings + G * kRing * 2 * nslot);
  float* comb = reinterpret_cast<float*>(mr + kRing * blockDim.x);
  const bool use_ring = kRing > 0 && aligned_x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(static_cast<long long>(R), r0 + rows_per_block);
  const int n_iter = rows_per_block / G;
  auto row_of = [&](int j) { return r0 + g + static_cast<long long>(j) * G; };
  Vec8<T> xv[kHeld], dv[kHeld];
  // row j's x, dy, mean and rstd into ring stage j % STAGES
  auto fetch = [&](int j) {
    const long long r = row_of(j);
    const int st = j % (kRing > 0 ? kRing : 1);
    const bool live = r < r1;
    const long long at = live ? r : 0;
    fetch_row<T, kHeld, WPR>(x + at * C, C, live, true,
                             ring + st * 2 * nslot, xv, v, lane);
    fetch_row<T, kHeld, WPR>(dy + at * C, C, live, true,
                             ring + (st * 2 + 1) * nslot, dv, v, lane);
    const unsigned m_at = smem_u32(mr + st * blockDim.x + threadIdx.x);
    cp_async4(m_at, mu + at, live);
    cp_async4(m_at + 4, rstd + at, live);
    cp_async_commit();
  };
  if (use_ring) {
#pragma unroll
    for (int j = 0; j < kRing - 1; ++j) fetch(j);
  }
  stage_w(ws, w, C, aligned_w);
  __syncthreads();
  float dwa[VPL][kVec] = {}, dba[VPL][kVec] = {};
  for (int j = 0; j < n_iter; ++j) {
    const long long r = row_of(j);
    const bool live = r < r1;
    float m = 0.f, rs = 0.f;
    if (use_ring) {
      fetch(j + kRing - 1);  // into the stage row j - 1 left
      cp_async_wait<(kRing > 0 ? kRing : 1) - 1>();
      const int st = j % (kRing > 0 ? kRing : 1);
      const Vec8<T>* slot = ring + st * 2 * nslot + v * kWarp + lane;
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        xv[k] = slot[k * WPR * kWarp];
        dv[k] = slot[nslot + k * WPR * kWarp];
      }
      const float2 mrs = mr[st * blockDim.x + threadIdx.x];
      m = mrs.x;
      rs = mrs.y;
    } else if (live) {
      m = mu[r];
      rs = rstd[r];
      if constexpr (STAGES > 0) {
        fetch_row<T, kHeld, WPR>(x + r * C, C, true, aligned_x, nullptr, xv,
                                 v, lane);
        fetch_row<T, kHeld, WPR>(dy + r * C, C, true, aligned_x, nullptr, dv,
                                 v, lane);
      }
    }
    const T* xr = x + (live ? r : 0) * C;
    const T* dyr = dy + (live ? r : 0) * C;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = col_of<WPR>(k, v, lane);
      if (c >= C || !live) continue;
      float xf[kVec], df[kVec];
      if constexpr (STAGES > 0) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          xf[i] = to_f32(xv[k].v[i]);
          df[i] = to_f32(dv[k].v[i]);
        }
      } else {
        load8(xr, c, C, static_cast<bool>(aligned_x), xf);
        load8(dyr, c, C, static_cast<bool>(aligned_x), df);
      }
      const Vec8<TW> wk = lds(ws + c / kVec);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        // past the row's end dy is 0 and so wdy: nothing is added
        const float xh = (xf[i] - m) * rs;
        const float wdy = df[i] * to_f32(wk.v[i]);
        s1 += xh * wdy;
        s2 += wdy;
        dwa[k][i] += df[i] * xh;
        dba[k][i] += df[i];
      }
    }
    const float2 cs = group_sum2<WPR>(s1, s2, red[j & 1] + g * WPR, v);
    if (!live) continue;
    const float c1 = cs.x / C, c2 = cs.y / C;
    T* dxr = dx + r * C;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = col_of<WPR>(k, v, lane);
      if (c >= C) continue;
      float xf[kVec], df[kVec], o[kVec];
      if constexpr (STAGES > 0) {
        opaque(xv[k]);
        opaque(dv[k]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          xf[i] = to_f32(xv[k].v[i]);
          df[i] = to_f32(dv[k].v[i]);
        }
      } else {
        load8(xr, c, C, static_cast<bool>(aligned_x), xf);
        load8(dyr, c, C, static_cast<bool>(aligned_x), df);
      }
      const Vec8<TW> wk = lds(ws + c / kVec);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xh = (xf[i] - m) * rs;
        o[i] = (df[i] * to_f32(wk.v[i]) - xh * c1 - c2) * rs;
      }
      store8(dxr, c, C, static_cast<bool>(aligned_x), o);
    }
  }
  if (use_ring) cp_async_wait<0>();
  // the finalize may launch now; it waits for this grid's memory
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the block's groups combine dw/db in group order: comb[f][i][slot]
  // (slot-major per element, so a warp's stores hit 32 banks)
  const int slot0 = v * kWarp + lane;
  for (int h = 0; h < G - 1; ++h) {
    if (g == h) {
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int at = i * nslot + k * WPR * kWarp + slot0;
          comb[at] = h ? comb[at] + dwa[k][i] : dwa[k][i];
          comb[kVec * nslot + at] =
              h ? comb[kVec * nslot + at] + dba[k][i] : dba[k][i];
        }
    }
    __syncthreads();
  }
  if (g == G - 1) {
    float* pw = part + static_cast<size_t>(blockIdx.x) * C;
    float* pb = part + static_cast<size_t>(gridDim.x + blockIdx.x) * C;
    const bool al = C % 4 == 0;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      float ow[kVec], ob[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int at = i * nslot + k * WPR * kWarp + slot0;
        ow[i] = G > 1 ? comb[at] + dwa[k][i] : dwa[k][i];
        ob[i] = G > 1 ? comb[kVec * nslot + at] + dba[k][i] : dba[k][i];
      }
      const int c = col_of<WPR>(k, v, lane);
      store8(pw, c, C, al, ow);
      store8(pb, c, C, al, ob);
    }
  }
}

// dw[c], db[c] = the strips' partials of column c added in strip order:
// thread (g, col) adds the strips g, g + 32, ... in order (loads issued
// eight strips ahead), then thread (0, col) adds the 32 groups in order
// and rounds once to w's dtype.
template <typename TW>
__global__ void __launch_bounds__(kFinalizeCols * kFinalizeGroups)
    ln_finalize_kernel(const float* __restrict__ part, int n_strips, int C,
                       TW* __restrict__ dw, TW* __restrict__ db) {
  __shared__ float sw[kFinalizeGroups][kFinalizeCols + 1];
  __shared__ float sb[kFinalizeGroups][kFinalizeCols + 1];
  const int col = threadIdx.x % kFinalizeCols;
  const int g = threadIdx.x / kFinalizeCols;
  const int c = blockIdx.x * kFinalizeCols + col;
  // the backward kernel's partials, complete and visible (a no-op when
  // not launched as a programmatic dependent)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float aw = 0.f, ab = 0.f;
  if (c < C) {
#pragma unroll 8
    for (int s = g; s < n_strips; s += kFinalizeGroups) {
      aw += part[static_cast<long long>(s) * C + c];
      ab += part[static_cast<long long>(n_strips + s) * C + c];
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

// -- launches ---------------------------------------------------------------

// (vectors a lane, warps a row, stages) as one switch key
__host__ __device__ constexpr int layout_key(int vpl, int wpr, int stages) {
  return (vpl * 64 + wpr) * 8 + stages;
}

#define LN_FWD(V, W, S) \
  reinterpret_cast<void*>(ln_fwd_kernel<T, TW, V, W, S>)
#define LN_BWD(V, W, S) \
  reinterpret_cast<void*>(ln_bwd_kernel<T, TW, V, W, S>)

// The built layouts (vectors a lane, warps a row, stages), which
// ops/kernels/layer_norm.py `row_layout` picks: a warp a row with 1, 2 or
// 4 vectors a lane, wider rows at 4 vectors a lane over 2-16 warps;
// rings of 3 rows up to 2048 columns, 2 up to 8192, none beyond. For
// bf16 x, w and b also the other layouts that tools/kernel_ab.py times
// at GPT-medium's and GPT-1.3B's widths.
template <typename T, typename TW>
void* fwd_kernel(int key) {
  switch (key) {
    case layout_key(1, 1, 3): return LN_FWD(1, 1, 3);
    case layout_key(2, 1, 3): return LN_FWD(2, 1, 3);
    case layout_key(4, 1, 3): return LN_FWD(4, 1, 3);
    case layout_key(4, 2, 3): return LN_FWD(4, 2, 3);
    case layout_key(4, 4, 2): return LN_FWD(4, 4, 2);
    case layout_key(4, 8, 2): return LN_FWD(4, 8, 2);
    case layout_key(4, 16, 1): return LN_FWD(4, 16, 1);
  }
  if constexpr (sizeof(T) == 2 && sizeof(TW) == 2) {
    switch (key) {
      case layout_key(4, 1, 1): return LN_FWD(4, 1, 1);
      case layout_key(4, 1, 2): return LN_FWD(4, 1, 2);
      case layout_key(4, 1, 4): return LN_FWD(4, 1, 4);
      case layout_key(4, 2, 1): return LN_FWD(4, 2, 1);
      case layout_key(2, 2, 3): return LN_FWD(2, 2, 3);
      case layout_key(2, 4, 3): return LN_FWD(2, 4, 3);
    }
  }
  return nullptr;
}

// a warp a row with 1 or 2 vectors a lane, wider rows at 2 vectors a lane
// over 2-16 warps, rings as the forward's; rows wider than 8192 read
// twice, 4 vectors a lane over 16 warps; for bf16 x, w and b also the
// layouts tools/kernel_ab.py times
template <typename T, typename TW>
void* bwd_kernel(int key) {
  switch (key) {
    case layout_key(1, 1, 3): return LN_BWD(1, 1, 3);
    case layout_key(2, 1, 3): return LN_BWD(2, 1, 3);
    case layout_key(2, 2, 3): return LN_BWD(2, 2, 3);
    case layout_key(2, 4, 3): return LN_BWD(2, 4, 3);
    case layout_key(2, 8, 2): return LN_BWD(2, 8, 2);
    case layout_key(2, 16, 2): return LN_BWD(2, 16, 2);
    case layout_key(4, 16, 0): return LN_BWD(4, 16, 0);
  }
  if constexpr (sizeof(T) == 2 && sizeof(TW) == 2) {
    switch (key) {
      case layout_key(2, 2, 1): return LN_BWD(2, 2, 1);
      case layout_key(2, 2, 2): return LN_BWD(2, 2, 2);
      case layout_key(2, 2, 4): return LN_BWD(2, 2, 4);
      case layout_key(2, 4, 1): return LN_BWD(2, 4, 1);
      case layout_key(1, 4, 3): return LN_BWD(1, 4, 3);
      case layout_key(1, 8, 3): return LN_BWD(1, 8, 3);
    }
  }
  return nullptr;
}

#undef LN_FWD
#undef LN_BWD

void* kernel_of(int backward, int vpl, int wpr, int stages, int x_dtype,
                int w_dtype) {
  using bf16 = __nv_bfloat16;
  const int key = layout_key(vpl, wpr, stages);
  if (backward) {
    if (x_dtype == 1 && w_dtype == 1) return bwd_kernel<bf16, bf16>(key);
    if (x_dtype == 1) return bwd_kernel<bf16, float>(key);
    if (w_dtype == 1) return bwd_kernel<float, bf16>(key);
    return bwd_kernel<float, float>(key);
  }
  if (x_dtype == 1 && w_dtype == 1) return fwd_kernel<bf16, bf16>(key);
  if (x_dtype == 1) return fwd_kernel<bf16, float>(key);
  if (w_dtype == 1) return fwd_kernel<float, bf16>(key);
  return fwd_kernel<float, float>(key);
}

// dynamic shared memory of a block: w (and, forward, b) as loaded; the
// groups' rings of x (and dy), a lane's vectors at each stage; the
// backward's mean and rstd, 8 bytes a thread a stage; in a backward
// block of more than one group the groups' dw/db combine, 2 x 8 floats a
// vector of a row group
size_t smem_bytes(int backward, int vpl, int wpr, int stages, int threads,
                  int C, int x_dtype, int w_dtype) {
  const size_t nvec = (static_cast<size_t>(C) + kVec - 1) / kVec;
  const size_t groups = threads / (wpr * kWarp);
  const size_t slots = static_cast<size_t>(vpl) * wpr * kWarp;
  const size_t ring = stages > 1 ? stages : 0;
  const size_t xvec = x_dtype == 1 ? 16 : 32, wvec = w_dtype == 1 ? 16 : 32;
  if (!backward) return 2 * nvec * wvec + groups * ring * slots * xvec;
  return nvec * wvec + groups * ring * 2 * slots * xvec +
         ring * threads * 8 +
         (groups > 1 ? 2 * kVec * slots * sizeof(float) : 0);
}

// the layout's kernel, checked against the block and its shared memory;
// the SM's shared memory carved out to the most (the kernels barely use
// L1)
cudaError_t checked_kernel(void** fn, int backward, int vpl, int wpr,
                           int stages, int threads, size_t smem, int x_dtype,
                           int w_dtype) {
  *fn = kernel_of(backward, vpl, wpr, stages, x_dtype, w_dtype);
  if (*fn == nullptr || threads <= 0 || threads > block_cap(wpr) ||
      threads % (wpr * kWarp) != 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      *fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  // a block may hold 48 KB of shared memory, the static part included,
  // unless the kernel opts in
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  return e;
}

}  // namespace

extern "C" {

// the widest row the kernels take
int layer_norm_max_cols() { return kMaxCols; }

// blocks of `threads` threads the card keeps resident on one SM for a
// layout's kernel (backward 0 or 1) on rows of C columns, with the
// shared memory its launch gives it; a negative cudaError when there is
// no such kernel or it does not fit.
int layer_norm_blocks_per_sm(int backward, int vpl, int wpr, int stages,
                             int threads, int C, int x_dtype, int w_dtype) {
  const size_t smem = smem_bytes(backward, vpl, wpr, stages, threads, C,
                                 x_dtype, w_dtype);
  void* fn = nullptr;
  cudaError_t e = checked_kernel(&fn, backward, vpl, wpr, stages, threads,
                                 smem, x_dtype, w_dtype);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// dtypes: 0 float32, 1 bfloat16 (x_dtype for x, y; w_dtype for w, b).
// aligned_x: x and y start 16-byte aligned and a row is a multiple of 16
// bytes; aligned_w: w and b start 16-byte aligned. Layout: vpl vectors a
// lane, wpr warps a row, rings of `stages` rows, blocks of `threads`
// threads, `blocks` blocks of rows_per_block consecutive rows (a
// multiple of threads / (32 * wpr); the last block may hold fewer).
int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                   float* mu, float* rstd, int R, int C, float eps, int vpl,
                   int wpr, int stages, int threads, int blocks,
                   int rows_per_block, int x_dtype, int w_dtype,
                   int aligned_x, int aligned_w, void* stream) {
  const size_t smem = smem_bytes(0, vpl, wpr, stages, threads, C, x_dtype,
                                 w_dtype);
  void* fn = nullptr;
  cudaError_t e = checked_kernel(&fn, 0, vpl, wpr, stages, threads, smem,
                                 x_dtype, w_dtype);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&x, &w, &b, &y, &mu, &rstd, &R, &C, &rows_per_block,
                  &eps, &aligned_x, &aligned_w};
  return static_cast<int>(
      cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream)));
}

// part: float32 [2][blocks][C] scratch (strip s's dw row s, its db row
// blocks + s). Strip s holds the rows [s * rows_per_block, (s + 1) *
// rows_per_block) that are < R. dx in x's dtype; dw, db in w's dtype.
// aligned_x covers x, dy and dx. Two launches: the strips, then their
// ordered sum.
int layer_norm_bwd(const void* x, const void* w, const float* mu,
                   const float* rstd, const void* dy, void* dx, float* part,
                   void* dw, void* db, int R, int C, int vpl, int wpr,
                   int stages, int threads, int blocks, int rows_per_block,
                   int x_dtype, int w_dtype, int aligned_x, int aligned_w,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(1, vpl, wpr, stages, threads, C, x_dtype,
                                 w_dtype);
  void* fn = nullptr;
  cudaError_t e = checked_kernel(&fn, 1, vpl, wpr, stages, threads, smem,
                                 x_dtype, w_dtype);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&x,    &w, &mu, &rstd,           &dy,        &dx,
                  &part, &R, &C,  &rows_per_block, &aligned_x, &aligned_w};
  e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + kFinalizeCols - 1) / kFinalizeCols);
  cfg.blockDim = dim3(kFinalizeCols * kFinalizeGroups);
  cfg.stream = s;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = kFinalizeEarly;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  const float* p = part;
  if (w_dtype == 1)
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, ln_finalize_kernel<__nv_bfloat16>, p, blocks, C,
        static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db)));
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, ln_finalize_kernel<float>, p, blocks, C,
                         static_cast<float*>(dw), static_cast<float*>(db)));
}

}  // extern "C"
