// Flash attention for training on NVIDIA Hopper (sm_90a), CUDA C++:
// the forward pass and the two backward passes.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel  <- `_fwd_kernel` (pallas_call in `_flash_fwd_impl`)
//   flash_dq_kernel   <- `_dq_kernel`  (first pallas_call of `_flash_bwd`)
//   flash_dkv_kernel  <- `_dkv_kernel` (second pallas_call of `_flash_bwd`)
//
// With s = scale * q . k over one (batch, head):
//   forward: out = softmax(s) . v and lse = m + log(l) per query row, by an
//            online softmax in float32 (finite mask value -1e30, masked
//            probabilities zeroed explicitly);
//   dQ:      p = exp(s - lse), dp = dO . v^T, ds = p * (dp - delta) * scale,
//            dq = ds . k, where delta = rowsum(dO * out) comes from the caller;
//   dK/dV:   dv = p^T . dO, dk = ds^T . q.
// Causal means row >= col with top-left alignment (the Pallas kernel's
// `attention_core.causal_valid`); tiles strictly above the diagonal are
// skipped. T need not be a multiple of the tile: rows and columns past the
// end are masked.
//
// Layout: q, k, v and dO are [B, T, H, D] with any batch, seq and head
// strides (in elements) and a unit last stride, so the q/k/v views that
// `unbind` makes of a fused [B, T, 3, H, D] projection are read in place.
// out, dq, dk and dv are written contiguous [B, T, H, D]; lse and delta
// are float32 [B, H, Tq]. Inputs are float32 or bfloat16; sums are float32.
//
// What bounds it on the card. At the GPT-medium training shape (B 8,
// T 1024, H 16, D 64, causal, bf16) a call does 1.7e10 (forward),
// 2.6e10 (dQ) or 3.4e10 (dK/dV) flops and moves 68, 85 or 102 MB, so
// the least time is about 20 us for the forward (its bytes over
// 3.35 TB/s) and 26 and 35 us for dQ and dK/dV (their flops over the
// tensor cores' 989 TFLOP/s). What this first design does about it: every tile of
// q, k, v and dO is read from device memory once per thread block and
// reused 64 times from shared memory, so the kernels are bound by the
// arithmetic and not by bytes; but the arithmetic runs on the CUDA cores
// in float32 (at most 67 TFLOP/s), so they sit an order of magnitude
// above the bound. Each thread computes a 4 x 4 block of a 64 x 64 score
// tile from float4 shared-memory reads (16 FMAs per two loads), tiles
// are staged transposed where a product reads them down a column, and
// the causal forward launches its longest q tiles first to shorten the
// tail. dK/dV loops over q tiles inside one block per kv tile, so it
// needs no atomics. Not done yet (later work): tensor cores (mma/wgmma
// with bf16 operands), cp.async/TMA double buffering, head dims other
// than 64.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes
// (ops/kernels/flash_attention.py). Each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                 // head dim the kernels are built for
constexpr int kTile = 64;              // q rows / kv cols of one tile
constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 each
constexpr int kRStride = kD + 4;       // padded row of a row-major tile
constexpr int kPStride = kTile + 4;    // padded row of a 64 x 64 tile
constexpr int kPerThread = kD / 16;    // output columns per thread
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh;  // element strides of [B, T, H, D]
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;  // dO
  int H, Tq, Tk;
  float scale;
  int causal;
};

__device__ __forceinline__ void unpack(const uint4& u, const float*, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, const __nv_bfloat16*,
                                       float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(a, b);
  h[1] = __floats2bfloat162_rn(c, d);
}

// Max / sum over the 16 lanes that share a row group (tid = ty*16 + tx).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Stage rows [r0, r0 + kTile) of one (batch, head) slice (row stride
// `st`, unit column stride) into shared memory as float32 times `mul`:
// transposed into tr[d * kTile + row] and/or row-major into
// rm[row * kRStride + d]. Rows at or past n_rows are zero. Consecutive
// threads take consecutive rows, so both stores are free of bank
// conflicts.
template <typename T>
__device__ __forceinline__ void stage(const T* base, long long st, int r0,
                                      int n_rows, float mul, float* tr,
                                      float* rm) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = kD / kVec;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int row = i % kTile, c = i / kTile;
    float f[kVec];
    if (r0 + row < n_rows) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          base + (long long)(r0 + row) * st + c * kVec);
      unpack(u, base, f);
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x) f[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < kVec; ++x) f[x] *= mul;
    if (tr != nullptr) {
#pragma unroll
      for (int x = 0; x < kVec; ++x) tr[(c * kVec + x) * kTile + row] = f[x];
    }
    if (rm != nullptr) {
#pragma unroll
      for (int x = 0; x < kVec; x += 4)
        store4(rm + row * kRStride + c * kVec + x, f[x], f[x + 1], f[x + 2],
               f[x + 3]);
    }
  }
}

// s[i][j] = sum_d a[d][ty*4 + i] * b[d][tx*4 + j]: a 4 x 4 block of the
// product of two transposed tiles ([kD][kTile] each).
__device__ __forceinline__ void dot_tt(const float* a, const float* b, int ty,
                                       int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * kTile + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + d * kTile + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

// acc[i][c] += sum_j p[j][ty*4 + i] * r[j][tx*4 + c]: p is a 64 x 64
// tile stored [j][row] (row stride kPStride), r a row-major tile.
__device__ __forceinline__ void dot_pr(const float* p, const float* r, int ty,
                                       int tx, float (&acc)[4][kPerThread]) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(p + j * kPStride + ty * 4);
    const float4 y = *reinterpret_cast<const float4*>(r + j * kRStride + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kPerThread; ++c)
        acc[i][c] = fmaf(xv[i], yv[c], acc[i][c]);
  }
}

// Write a thread's 4 x 4 block s[i][j] (row ty*4 + i, column tx*4 + j)
// into p stored [column][row], so dot_pr reads it down the columns.
__device__ __forceinline__ void put_t(float* p, int ty, int tx,
                                      const float (&s)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store4(p + (tx * 4 + j) * kPStride + ty * 4, s[0][j], s[1][j], s[2][j],
           s[3][j]);
}

__device__ __forceinline__ bool valid(int row, int col, int Tq, int Tk,
                                      int causal) {
  return row < Tq && col < Tk && (!causal || row >= col);
}

// ---- forward --------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* q_t = sm;                      // [kD][kTile], pre-scaled
  float* k_t = q_t + kD * kTile;        // [kD][kTile]
  float* v_r = k_t + kD * kTile;        // [kTile][kRStride]
  float* p_t = v_r + kTile * kRStride;  // [kTile][kPStride]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  // the longest causal tiles (the last q rows) launch first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  stage(q, p.q_st, r0, p.Tq, p.scale, q_t, nullptr);

  float m[4], l[4], o[4][kPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's columns only; summed over the group at the end
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) o[i][c] = 0.f;
  }
  const int n_kv = p.causal ? min(p.Tk, r0 + kTile) : p.Tk;
  for (int c0 = 0; c0 < n_kv; c0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage(k, p.k_st, c0, p.Tk, 1.f, k_t, nullptr);
    stage(v, p.v_st, c0, p.Tk, 1.f, nullptr, v_r);
    __syncthreads();
    float s[4][4];
    dot_tt(q_t, k_t, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = valid(row, c0 + tx * 4 + j, p.Tq, p.Tk, p.causal);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kPerThread; ++c) o[i][c] *= alpha;
      m[i] = m_new;
    }
    put_t(p_t, ty, tx, s);
    __syncthreads();
    dot_pr(p_t, v_r, ty, tx, o);
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    const float l_safe = fmaxf(group_sum(l[i]), 1e-30f);
    if (row < p.Tq) {
      const float inv = 1.f / l_safe;
      T* orow = out + (((long long)b * p.Tq + row) * p.H + h) * kD + tx * 4;
      store4(orow, o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
      if (tx == 0) p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l_safe);
    }
  }
}

// ---- dQ -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* q_t = sm;                       // [kD][kTile], pre-scaled
  float* do_t = q_t + kD * kTile;        // [kD][kTile]
  float* k_t = do_t + kD * kTile;        // [kD][kTile]
  float* v_t = k_t + kD * kTile;         // [kD][kTile]
  float* k_r = v_t + kD * kTile;         // [kTile][kRStride]
  float* ds_t = k_r + kTile * kRStride;  // [kTile][kPStride]
  float* lse_s = ds_t + kTile * kPStride;  // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  stage(q, p.q_st, r0, p.Tq, p.scale, q_t, nullptr);
  stage(dout, p.o_st, r0, p.Tq, 1.f, do_t, nullptr);
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    const long long at = (long long)bh * p.Tq + row;
    lse_s[threadIdx.x] = row < p.Tq ? p.lse_in[at] : 0.f;
    delta_s[threadIdx.x] = row < p.Tq ? p.delta[at] : 0.f;
  }

  float acc[4][kPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) acc[i][c] = 0.f;
  const int n_kv = p.causal ? min(p.Tk, r0 + kTile) : p.Tk;
  for (int c0 = 0; c0 < n_kv; c0 += kTile) {
    __syncthreads();
    stage(k, p.k_st, c0, p.Tk, 1.f, k_t, k_r);
    stage(v, p.v_st, c0, p.Tk, 1.f, v_t, nullptr);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tt(q_t, k_t, ty, tx, s);
    dot_tt(do_t, v_t, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = valid(r0 + rl, c0 + tx * 4 + j, p.Tq, p.Tk, p.causal);
        const float pij = ok ? expf(s[i][j] - lse_s[rl]) : 0.f;
        s[i][j] = pij * (dp[i][j] - delta_s[rl]) * p.scale;
      }
    }
    put_t(ds_t, ty, tx, s);
    __syncthreads();
    dot_pr(ds_t, k_r, ty, tx, acc);
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row < p.Tq)
      store4(dq + (((long long)b * p.Tq + row) * p.H + h) * kD + tx * 4,
             acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---- dK / dV ----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* k_t = sm;                        // [kD][kTile], pre-scaled
  float* v_t = k_t + kD * kTile;          // [kD][kTile]
  float* q_t = v_t + kD * kTile;          // [kD][kTile]
  float* do_t = q_t + kD * kTile;         // [kD][kTile]
  float* q_r = do_t + kD * kTile;         // [kTile][kRStride]
  float* do_r = q_r + kTile * kRStride;   // [kTile][kRStride]
  float* p_s = do_r + kTile * kRStride;   // [q row][kv col], kPStride
  float* ds_s = p_s + kTile * kPStride;   // [q row][kv col], kPStride
  float* lse_s = ds_s + kTile * kPStride;  // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int c0 = blockIdx.y * kTile;  // the first kv tiles have most q tiles
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  stage(k, p.k_st, c0, p.Tk, p.scale, k_t, nullptr);
  stage(v, p.v_st, c0, p.Tk, 1.f, v_t, nullptr);

  float dk[4][kPerThread], dv[4][kPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) dk[i][c] = dv[i][c] = 0.f;
  // causal: q tiles from the diagonal down (row >= col needs r0 + 63 >= c0)
  const int first = p.causal ? c0 / kTile : 0;
  for (int r0 = first * kTile; r0 < p.Tq; r0 += kTile) {
    __syncthreads();
    stage(q, p.q_st, r0, p.Tq, 1.f, q_t, q_r);
    stage(dout, p.o_st, r0, p.Tq, 1.f, do_t, do_r);
    if (threadIdx.x < kTile) {
      const int row = r0 + threadIdx.x;
      const long long at = (long long)bh * p.Tq + row;
      lse_s[threadIdx.x] = row < p.Tq ? p.lse_in[at] : 0.f;
      delta_s[threadIdx.x] = row < p.Tq ? p.delta[at] : 0.f;
    }
    __syncthreads();
    // transposed scores: st[i][j] for kv col ty*4 + i and q row tx*4 + j
    float st[4][4], dpt[4][4];
    dot_tt(k_t, q_t, ty, tx, st);
    dot_tt(v_t, do_t, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx * 4 + j;
        const bool ok = valid(r0 + rl, c0 + ty * 4 + i, p.Tq, p.Tk, p.causal);
        const float pij = ok ? expf(st[i][j] - lse_s[rl]) : 0.f;
        st[i][j] = pij;
        dpt[i][j] = pij * (dpt[i][j] - delta_s[rl]) * p.scale;
      }
    }
    put_t(p_s, ty, tx, st);
    put_t(ds_s, ty, tx, dpt);
    __syncthreads();
    dot_pr(p_s, do_r, ty, tx, dv);
    dot_pr(ds_s, q_r, ty, tx, dk);
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = c0 + ty * 4 + i;
    if (col < p.Tk) {
      const long long at = (((long long)b * p.Tk + col) * p.H + h) * kD + tx * 4;
      store4(dk_out + at, dk[i][0], dk[i][1], dk[i][2], dk[i][3]);
      store4(dv_out + at, dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
    }
  }
}

constexpr size_t kTileT = (size_t)kD * kTile * sizeof(float);
constexpr size_t kTileR = (size_t)kTile * kRStride * sizeof(float);
constexpr size_t kTileP = (size_t)kTile * kPStride * sizeof(float);
constexpr size_t kRowVecs = 2 * kTile * sizeof(float);
constexpr size_t kSmemFwd = 2 * kTileT + kTileR + kTileP;
constexpr size_t kSmemDq = 4 * kTileT + kTileR + kTileP + kRowVecs;
constexpr size_t kSmemDkv = 4 * kTileT + 2 * kTileR + 2 * kTileP + kRowVecs;

template <typename K>
cudaError_t launch(K kernel, size_t smem, int B, int H, int T,
                   const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (T + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const long long* s, int H, int Tq, int Tk, float scale,
                   int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_sb = s[0]; p.q_st = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_st = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_st = s[7]; p.v_sh = s[8];
  p.o_sb = s[9]; p.o_st = s[10]; p.o_sh = s[11];
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.scale = scale;
  p.causal = causal;
  return p;
}

bool bad_shape(int B, int H, int Tq, int Tk, int head_dim) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || head_dim != kD ||
         (long long)B * H > 0x7fffffffLL ||
         (Tq + kTile - 1) / kTile > 65535 || (Tk + kTile - 1) / kTile > 65535;
}

}  // namespace

extern "C" {

// Head dim the kernels are built for.
int flash_attention_head_dim() { return kD; }

// strides: 12 element strides, (batch, seq, head) of q, k, v and dO in
// that order (dO's are ignored by the forward). dtype: 0 = float32,
// 1 = bfloat16. Each returns a cudaError_t value (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, const long long* strides,
                        int B, int H, int Tq, int Tk, int head_dim,
                        float scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, H, Tq, Tk, head_dim)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, strides, H, Tq, Tk, scale, causal);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(flash_fwd_kernel<float>, kSmemFwd, B, H, Tq, p, s);
  if (dtype == 1)
    return (int)launch(flash_fwd_kernel<__nv_bfloat16>, kSmemFwd, B, H, Tq, p, s);
  return (int)cudaErrorInvalidValue;
}

int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, const long long* strides, int B, int H,
                       int Tq, int Tk, int head_dim, float scale, int causal,
                       int dtype, void* stream) {
  if (bad_shape(B, H, Tq, Tk, head_dim)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, strides, H, Tq, Tk, scale, causal);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(flash_dq_kernel<float>, kSmemDq, B, H, Tq, p, s);
  if (dtype == 1)
    return (int)launch(flash_dq_kernel<__nv_bfloat16>, kSmemDq, B, H, Tq, p, s);
  return (int)cudaErrorInvalidValue;
}

int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, const long long* strides, int B,
                        int H, int Tq, int Tk, int head_dim, float scale,
                        int causal, int dtype, void* stream) {
  if (bad_shape(B, H, Tq, Tk, head_dim)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, strides, H, Tq, Tk, scale, causal);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(flash_dkv_kernel<float>, kSmemDkv, B, H, Tk, p, s);
  if (dtype == 1)
    return (int)launch(flash_dkv_kernel<__nv_bfloat16>, kSmemDkv, B, H, Tk, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
