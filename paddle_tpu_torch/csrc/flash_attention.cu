// Flash attention for training on NVIDIA Hopper (sm_90a), CUDA C++:
// the forward pass and the two backward passes.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_tc_kernel, flash_fwd_kernel <- `_fwd_kernel`
//                                            (pallas_call in `_flash_fwd_impl`)
//   flash_dq_tc_kernel, flash_dq_kernel   <- `_dq_kernel`
//                                            (first pallas_call of `_flash_bwd`)
//   flash_dkv_tc_kernel, flash_dkv_kernel <- `_dkv_kernel`
//                                            (second pallas_call of `_flash_bwd`)
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
// are float32 [B, H, Tq]. Inputs are float32, bfloat16 or float16; sums
// are float32.
// The head dim D is 64 or 128 (kHeadDims); every kernel is a template on
// it.
//
// What bounds it on the card. At the GPT-medium training shape (B 8,
// T 1024, H 16, D 64, causal, bf16) a call does 1.7e10 (forward),
// 2.6e10 (dQ) or 3.4e10 (dK/dV) flops and moves 68, 85 or 102 MB, so
// the least time is about 20 us for the forward (its bytes over
// 3.35 TB/s) and 26 and 35 us for dQ and dK/dV (their flops over the
// tensor cores' 989 TFLOP/s). GPT-1.3B's shape (B 4, T 1024, H 16,
// D 128) does the same flops and moves the same bytes.
//
// Two designs live here, picked by the dtype:
// - bfloat16 (the training path: flash_fwd_tc_kernel, flash_dq_tc_kernel,
//   flash_dkv_tc_kernel) and float16 (the same templates on __half, for
//   amp.auto_cast's float16 mode) run every product on the tensor cores with
//   Hopper's warpgroup MMA (wgmma.m64nNk16, float32 accumulators). A
//   block of one warpgroup keeps 64 rows resident (Q for the forward, Q
//   and dO for dQ, K and V for dK/dV) and streams the other operand's
//   tiles through cp.async stages (three; two for a tile only the first
//   products read), so the next tile loads while this one is multiplied
//   and the last tile's second products still run; two to four blocks
//   share an SM, so one block's exponentials overlap another's
//   products. The forward's online softmax runs in
//   registers on S's accumulator (row max and sum over the four threads
//   of a quad, exp2 with scale * log2(e) folded in, O rescaled by
//   alpha). P and dS stay in registers: the accumulator of S is already
//   laid out as the A operand of the next product, so they are rounded
//   to bf16 there (as FlashAttention-3 does) and the second products
//   read their B tile MN-major from the same 128-byte-swizzled shared
//   tile the first products read K-major. No atomics: dQ and dK/dV stay
//   two kernels, each output written once.
// - float32 (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel) runs
//   its products on the CUDA cores in float32 (at most 67 TFLOP/s):
//   each thread computes a 4 x 4 block of a 64 x 64 score tile from
//   float4 shared-memory reads, tiles are staged transposed where a
//   product reads them down a column, and every tile is read from device
//   memory once per block and reused 64 times. float32 stays off the
//   tensor cores: TF32 keeps ~3 digits, against the float32 route's
//   1e-4 tolerance.
// Both launch their longest causal tiles first to shorten the tail.
// Not done yet (later work): TMA loads and warp-specialised producers,
// head dims other than 64 and 128.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes
// (ops/kernels/flash_attention.py). Each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kHeadDims[] = {64, 128};  // head dims the kernels are built for
constexpr int kTile = 64;               // q rows / kv cols of one tile
constexpr int kThreads = 256;           // 16 x 16 threads, 4 x 4 each
constexpr int kPStride = kTile + 4;     // padded row of a 64 x 64 tile
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

__device__ __forceinline__ bool valid(int row, int col, int Tq, int Tk,
                                      int causal) {
  return row < Tq && col < Tk && (!causal || row >= col);
}

// ---- float32 on the CUDA cores ---------------------------------------------
//
// A thread (tx, ty) of the 16 x 16 owns rows ty*4 .. ty*4 + 3 of a tile
// and, of a [kTile][D] product, columns tx * D/16 .. + D/16 - 1. A
// row-major tile is padded to D + 4 floats a row.

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
// `st`, unit column stride) into shared memory times `mul`: transposed
// into tr[d * kTile + row] and/or row-major into rm[row * (D + 4) + d].
// Rows at or past n_rows are zero. Consecutive threads take consecutive
// rows, so both stores are free of bank conflicts.
template <int D>
__device__ __forceinline__ void stage(const float* base, long long st, int r0,
                                      int n_rows, float mul, float* tr,
                                      float* rm) {
  for (int i = threadIdx.x; i < kTile * (D / 4); i += kThreads) {
    const int row = i % kTile, c = 4 * (i / kTile);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < n_rows)
      f = *reinterpret_cast<const float4*>(base + (long long)(r0 + row) * st +
                                           c);
    f = make_float4(f.x * mul, f.y * mul, f.z * mul, f.w * mul);
    if (tr != nullptr) {
      tr[c * kTile + row] = f.x;
      tr[(c + 1) * kTile + row] = f.y;
      tr[(c + 2) * kTile + row] = f.z;
      tr[(c + 3) * kTile + row] = f.w;
    }
    if (rm != nullptr) *reinterpret_cast<float4*>(rm + row * (D + 4) + c) = f;
  }
}

// s[i][j] = sum_d a[d][ty*4 + i] * b[d][tx*4 + j]: a 4 x 4 block of the
// product of two transposed tiles ([D][kTile] each).
template <int D>
__device__ __forceinline__ void dot_tt(const float* a, const float* b, int ty,
                                       int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
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

// acc[i][c] += sum_j p[j][ty*4 + i] * r[j][tx*D/16 + c]: p is a 64 x 64
// tile stored [j][row] (row stride kPStride), r a row-major tile.
template <int D>
__device__ __forceinline__ void dot_pr(const float* p, const float* r, int ty,
                                       int tx, float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(p + j * kPStride + ty * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c4 = 0; c4 < D / 64; ++c4) {
      const float4 y = *reinterpret_cast<const float4*>(
          r + j * (D + 4) + tx * (D / 16) + 4 * c4);
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][4 * c4 + c] = fmaf(xv[i], yv[c], acc[i][4 * c4 + c]);
    }
  }
}

// Write a thread's 4 x 4 block s[i][j] (row ty*4 + i, column tx*4 + j)
// into p stored [column][row], so dot_pr reads it down the columns.
__device__ __forceinline__ void put_t(float* p, int ty, int tx,
                                      const float (&s)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(p + (tx * 4 + j) * kPStride + ty * 4) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// A thread's D/16 columns of one output row, times mul.
template <int N>
__device__ __forceinline__ void store_cols(float* o, const float (&x)[N],
                                           float mul) {
#pragma unroll
  for (int c4 = 0; c4 < N / 4; ++c4)
    *reinterpret_cast<float4*>(o + 4 * c4) =
        make_float4(x[4 * c4] * mul, x[4 * c4 + 1] * mul,
                    x[4 * c4 + 2] * mul, x[4 * c4 + 3] * mul);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int kPer = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float sm[];
  float* q_t = sm;                     // [D][kTile], pre-scaled
  float* k_t = q_t + D * kTile;        // [D][kTile]
  float* v_r = k_t + D * kTile;        // [kTile][D + 4]
  float* p_t = v_r + kTile * (D + 4);  // [kTile][kPStride]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  // the longest causal tiles (the last q rows) launch first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  stage<D>(q, p.q_st, r0, p.Tq, p.scale, q_t, nullptr);

  float m[4], l[4], o[4][kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's columns only; summed over the group at the end
#pragma unroll
    for (int c = 0; c < kPer; ++c) o[i][c] = 0.f;
  }
  const int n_kv = p.causal ? min(p.Tk, r0 + kTile) : p.Tk;
  for (int c0 = 0; c0 < n_kv; c0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage<D>(k, p.k_st, c0, p.Tk, 1.f, k_t, nullptr);
    stage<D>(v, p.v_st, c0, p.Tk, 1.f, nullptr, v_r);
    __syncthreads();
    float s[4][4];
    dot_tt<D>(q_t, k_t, ty, tx, s);
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
      for (int c = 0; c < kPer; ++c) o[i][c] *= alpha;
      m[i] = m_new;
    }
    put_t(p_t, ty, tx, s);
    __syncthreads();
    dot_pr<D>(p_t, v_r, ty, tx, o);
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    const float l_safe = fmaxf(group_sum(l[i]), 1e-30f);
    if (row < p.Tq) {
      store_cols(out + (((long long)b * p.Tq + row) * p.H + h) * D + tx * kPer,
                 o[i], 1.f / l_safe);
      if (tx == 0) p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l_safe);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  constexpr int kPer = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* q_t = sm;                         // [D][kTile], pre-scaled
  float* do_t = q_t + D * kTile;           // [D][kTile]
  float* k_t = do_t + D * kTile;           // [D][kTile]
  float* v_t = k_t + D * kTile;            // [D][kTile]
  float* k_r = v_t + D * kTile;            // [kTile][D + 4]
  float* ds_t = k_r + kTile * (D + 4);     // [kTile][kPStride]
  float* lse_s = ds_t + kTile * kPStride;  // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  stage<D>(q, p.q_st, r0, p.Tq, p.scale, q_t, nullptr);
  stage<D>(dout, p.o_st, r0, p.Tq, 1.f, do_t, nullptr);
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    const long long at = (long long)bh * p.Tq + row;
    lse_s[threadIdx.x] = row < p.Tq ? p.lse_in[at] : 0.f;
    delta_s[threadIdx.x] = row < p.Tq ? p.delta[at] : 0.f;
  }

  float acc[4][kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[i][c] = 0.f;
  const int n_kv = p.causal ? min(p.Tk, r0 + kTile) : p.Tk;
  for (int c0 = 0; c0 < n_kv; c0 += kTile) {
    __syncthreads();
    stage<D>(k, p.k_st, c0, p.Tk, 1.f, k_t, k_r);
    stage<D>(v, p.v_st, c0, p.Tk, 1.f, v_t, nullptr);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tt<D>(q_t, k_t, ty, tx, s);
    dot_tt<D>(do_t, v_t, ty, tx, dp);
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
    dot_pr<D>(ds_t, k_r, ty, tx, acc);
  }

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row < p.Tq)
      store_cols(dq + (((long long)b * p.Tq + row) * p.H + h) * D + tx * kPer,
                 acc[i], 1.f);
  }
}

// P and dS take turns in one shared tile (at D = 128 a second one would
// not fit in 227 KB).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  constexpr int kPer = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* k_t = sm;                         // [D][kTile], pre-scaled
  float* v_t = k_t + D * kTile;            // [D][kTile]
  float* q_t = v_t + D * kTile;            // [D][kTile]
  float* do_t = q_t + D * kTile;           // [D][kTile]
  float* q_r = do_t + D * kTile;           // [kTile][D + 4]
  float* do_r = q_r + kTile * (D + 4);     // [kTile][D + 4]
  float* p_s = do_r + kTile * (D + 4);     // [q row][kv col], kPStride
  float* lse_s = p_s + kTile * kPStride;   // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int c0 = blockIdx.y * kTile;  // the first kv tiles have most q tiles
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  stage<D>(k, p.k_st, c0, p.Tk, p.scale, k_t, nullptr);
  stage<D>(v, p.v_st, c0, p.Tk, 1.f, v_t, nullptr);

  float dk[4][kPer], dv[4][kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kPer; ++c) dk[i][c] = dv[i][c] = 0.f;
  // causal: q tiles from the diagonal down (row >= col needs r0 + 63 >= c0)
  const int first = p.causal ? c0 / kTile : 0;
  for (int r0 = first * kTile; r0 < p.Tq; r0 += kTile) {
    __syncthreads();
    stage<D>(q, p.q_st, r0, p.Tq, 1.f, q_t, q_r);
    stage<D>(dout, p.o_st, r0, p.Tq, 1.f, do_t, do_r);
    if (threadIdx.x < kTile) {
      const int row = r0 + threadIdx.x;
      const long long at = (long long)bh * p.Tq + row;
      lse_s[threadIdx.x] = row < p.Tq ? p.lse_in[at] : 0.f;
      delta_s[threadIdx.x] = row < p.Tq ? p.delta[at] : 0.f;
    }
    __syncthreads();
    // transposed scores: st[i][j] for kv col ty*4 + i and q row tx*4 + j
    float st[4][4], dpt[4][4];
    dot_tt<D>(k_t, q_t, ty, tx, st);
    dot_tt<D>(v_t, do_t, ty, tx, dpt);
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
    __syncthreads();
    dot_pr<D>(p_s, do_r, ty, tx, dv);
    __syncthreads();  // every thread has read P
    put_t(p_s, ty, tx, dpt);
    __syncthreads();
    dot_pr<D>(p_s, q_r, ty, tx, dk);
  }

  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = c0 + ty * 4 + i;
    if (col < p.Tk) {
      const long long at =
          (((long long)b * p.Tk + col) * p.H + h) * D + tx * kPer;
      store_cols(dk_out + at, dk[i], 1.f);
      store_cols(dv_out + at, dv[i], 1.f);
    }
  }
}

// ---- bfloat16 and float16 on the tensor cores --------------------------------
//
// A block is one warpgroup of 128 threads that owns a resident tile of 64
// rows and issues wgmma.m64nNk16.f32.T.T for them, T the element type
// (__nv_bfloat16 or __half, a template parameter of every kernel here:
// the same design, P and dS rounded to T). One warpgroup a
// block beat two on the H100 (PERF.md): two warpgroups of one block meet
// at every tile's barrier, so their products and exponentials coincide,
// while separate blocks drift apart and overlap.
//
// wgmma.cuh has the shared tile's layout, the accumulator's and the
// helpers that load, describe and multiply them.

// Stages of the streamed tiles. The next tile loads into the stage after
// the current one, which is not the one the last tile's second products
// may still be reading, so a tile's barrier need not wait for them and
// their latency hides behind it.
constexpr int kStages = 3;
// A streamed tile that only a tile's first products read (the forward's
// K, dQ's V) needs two: the tile's own wait saw those products finish
// before the next tile loads. The tile of shared memory saved is a
// fourth forward block an SM at D = 64 and a second dQ block at 128.
constexpr int kStagesFirst = 2;

// q rows a dK/dV block streams per tile: at D = 128, 32, so that the dK
// and dV accumulators (D / 2 floats a thread each) and S^T, dP^T (rows / 2
// each) fit the registers without a spill
template <int D>
__host__ __device__ constexpr int dkv_q_rows() {
  return 4096 / D;
}

// A thread's accumulator rows row0 and row0 + 8 of a [64 x D] product,
// times mul[0] and mul[1], into a contiguous [B, T, H, D] output of E,
// rows at or past T left out.
template <int D, typename E>
__device__ __forceinline__ void store_rows(E* out,
                                           const float (&d)[D / 2],
                                           const float (&mul)[2], int b,
                                           int T, int H, int h, int row0,
                                           int col0) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= T) continue;
    E* o = out + (((long long)b * T + row) * H + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) = pack2<E>(
          d[4 * j + 2 * hh] * mul[hh], d[4 * j + 2 * hh + 1] * mul[hh]);
  }
}

// Forward: a block owns 64 q rows (Q resident) and walks the kv tiles of
// 64 up to its diagonal; per tile S = Q.K^T, the online softmax on S in
// registers (m in log2 units of the scaled scores), O = alpha * O, and
// O += P.V with P rounded to E in registers. The product of P with V
// is issued one tile late, after the next tile's S (as FlashAttention-3
// does within a warpgroup), so it runs while that S's softmax does.
template <int D, typename E>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(Params p) {
  constexpr uint32_t kT = tc_tile<D>(64);
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sq = (smem_u32(smem_tc) + 1023u) & ~1023u;  // Q [64]
  const uint32_t sk = sq + kT;                     // K [kStagesFirst][64]
  const uint32_t sv = sk + kStagesFirst * kT;      // V [kStages][64]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * 64;  // longest first
  const int lane = threadIdx.x & 31;
  const int row0 = r0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int n_kv = p.causal ? min(p.Tk, r0 + 64) : p.Tk;
  const int n_tiles = (n_kv + 63) / 64;
  load_tile<D>(sq, q, p.q_st, r0, 64, p.Tq);
  load_tile<D>(sk, k, p.k_st, 0, 64, p.Tk);
  load_tile<D>(sv, v, p.v_st, 0, 64, p.Tk);
  cp_async_commit();
  const float scale2 = p.scale * kLog2e;

  // m: running row max of the scaled scores in log2 units; l: this
  // thread's part of the row sum (summed over the quad at the end); a:
  // the last tile's P, the A operand of its product with V
  float o[D / 2], s[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = 64 * it;
    const uint32_t kt = sk + (it % kStagesFirst) * kT;
    cp_async_wait_all();
    fence_proxy_async();
    // tile `it` is in; the stages tile it + 1 loads into were last read
    // by tile it - 1's S (K) and tile it - 2's O product (V), which the
    // waits in tile it - 1 saw finish; tile it - 1's V is read by the O
    // product issued below
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile<D>(sk + ((it + 1) % kStagesFirst) * kT, k, p.k_st, c0 + 64,
                   64, p.Tk);
      load_tile<D>(sv + ((it + 1) % kStages) * kT, v, p.v_st, c0 + 64, 64,
                   p.Tk);
      cp_async_commit();
    }
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(s, desc_k(sq, 64, kk), desc_k(kt, 64, kk), kk);
    wgmma_commit();
    if (it > 0) {
      const uint32_t vt = sv + ((it - 1) % kStages) * kT;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<E>(o, a[kk], desc_mn(vt, 64, kk));
      wgmma_commit();
      wgmma_wait<1>();  // S is in; the last tile's O product may still run
    } else {
      wgmma_wait<0>();
    }
    fence_acc(s);
    const bool edge = (p.causal && c0 + 63 > r0) || c0 + 64 > p.Tk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          if (edge && !valid(row0 + 8 * hh, c0 + 8 * j + col0 + e, p.Tq,
                             p.Tk, p.causal))
            s[i] = kNegInf;
          mx[hh] = fmaxf(mx[hh], s[i]);
        }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // the row's max over the quad of threads that hold it
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * scale2);
      alpha[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          s[i] = ex2(fmaf(s[i], scale2, -m[hh]));
          if (edge && !valid(row0 + 8 * hh, c0 + 8 * j + col0 + e, p.Tq,
                             p.Tk, p.causal))
            s[i] = 0.f;
          l[hh] += s[i];
        }
    wgmma_wait<0>();  // the last tile's O product is in
    fence_acc(o);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_a<E>(s, a);
  }
  wgmma_fence();
  const uint32_t vt = sv + ((n_tiles - 1) % kStages) * kT;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<E>(o, a[kk], desc_mn(vt, 64, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
    const float l_safe = fmaxf(l[hh], 1e-30f);
    inv[hh] = 1.f / l_safe;
    const int row = row0 + 8 * hh;
    if ((lane & 3) == 0 && row < p.Tq)
      p.lse[(long long)bh * p.Tq + row] = m[hh] * kLn2 + logf(l_safe);
  }
  store_rows<D>(static_cast<E*>(p.out), o, inv, b, p.Tq, p.H, h, row0,
                col0);
}

// dQ: a block owns 64 q rows (Q, dO, lse and delta resident) and walks the
// kv tiles of 64 up to its diagonal; per tile S = Q.K^T, dP = dO.V^T,
// dS = P * (dP - delta) * scale in registers, dQ += dS.K.
template <int D, typename E>
__global__ void __launch_bounds__(kTcThreads) flash_dq_tc_kernel(Params p) {
  constexpr uint32_t kT = tc_tile<D>(64);
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sq = (smem_u32(smem_tc) + 1023u) & ~1023u;  // Q [64]
  const uint32_t sdo = sq + kT;                              // dO [64]
  const uint32_t sk = sdo + kT;                   // K [kStages][64]
  const uint32_t sv = sk + kStages * kT;          // V [kStagesFirst][64]

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * 64;  // longest first
  const int lane = threadIdx.x & 31;
  const int row0 = r0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const E* dout = static_cast<const E*>(p.dout) + b * p.o_sb + h * p.o_sh;

  const int n_kv = p.causal ? min(p.Tk, r0 + 64) : p.Tk;
  const int n_tiles = (n_kv + 63) / 64;
  load_tile<D>(sq, q, p.q_st, r0, 64, p.Tq);
  load_tile<D>(sdo, dout, p.o_st, r0, 64, p.Tq);
  load_tile<D>(sk, k, p.k_st, 0, 64, p.Tk);
  load_tile<D>(sv, v, p.v_st, 0, 64, p.Tk);
  cp_async_commit();
  float lse2[2], dlt[2];  // lse in log2 units, and delta, of rows row0 (+8)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const long long at = (long long)bh * p.Tq + row;
    lse2[hh] = row < p.Tq ? p.lse_in[at] * kLog2e : 0.f;
    dlt[hh] = row < p.Tq ? p.delta[at] : 0.f;
  }
  const float scale2 = p.scale * kLog2e;

  float dq[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = 64 * it;
    const uint32_t kt = sk + (it % kStages) * kT;
    const uint32_t vt = sv + (it % kStagesFirst) * kT;
    cp_async_wait_all();
    fence_proxy_async();
    // tile `it` is in; the stages tile it + 1 loads into were last read
    // by tile it - 2's dQ product (K), which the wait below S in tile
    // it - 1 saw finish, and tile it - 1's dP (V); tile it - 1's dQ
    // product may still run
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile<D>(sk + ((it + 1) % kStages) * kT, k, p.k_st, c0 + 64, 64,
                   p.Tk);
      load_tile<D>(sv + ((it + 1) % kStagesFirst) * kT, v, p.v_st, c0 + 64,
                   64, p.Tk);
      cp_async_commit();
    }
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(s, desc_k(sq, 64, kk), desc_k(kt, 64, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(dp, desc_k(sdo, 64, kk), desc_k(vt, 64, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // the last dQ and S are in; P's exp overlaps dP
    fence_acc(s);
    const bool edge = (p.causal && c0 + 63 > r0) || c0 + 64 > p.Tk ||
                      r0 + 64 > p.Tq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          s[i] = ex2(fmaf(s[i], scale2, -lse2[hh]));
          if (edge && !valid(row0 + 8 * hh, c0 + 8 * j + col0 + e, p.Tq,
                             p.Tk, p.causal))
            s[i] = 0.f;
        }
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]) * p.scale;
    uint32_t a[4][4];
    to_a<E>(s, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<E>(dq, a[kk], desc_mn(kt, 64, kk));
    wgmma_commit();  // waited for below the next tile's S
  }
  wgmma_wait<0>();
  fence_acc(dq);
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<E*>(p.dq), dq, one, b, p.Tq, p.H, h, row0,
                col0);
}

// dK/dV: a block owns 64 kv rows (K and V resident) and walks the q tiles
// of dkv_q_rows<D>() rows (Q) from its diagonal down; per tile S^T = K.Q^T
// and dP^T = V.dO^T, P^T and dS^T in registers, dV += P^T.dO,
// dK += dS^T.Q. lse and delta, per column here, are staged beside each q
// tile.
template <int D, typename E>
__global__ void __launch_bounds__(kTcThreads) flash_dkv_tc_kernel(Params p) {
  constexpr int Q = dkv_q_rows<D>();
  constexpr uint32_t kT = tc_tile<D>(64), kQT = tc_tile<D>(Q);
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t pad = ((smem_u32(smem_tc) + 1023u) & ~1023u) -
                       smem_u32(smem_tc);
  const uint32_t sk = smem_u32(smem_tc) + pad;   // K [64]
  const uint32_t sv = sk + kT;                   // V [64]
  const uint32_t sq = sv + kT;                   // Q [kStages][Q]
  const uint32_t sdo = sq + kStages * kQT;       // dO [kStages][Q]
  const uint32_t svec = sdo + kStages * kQT;     // [kStages][lse, delta]
  const float* vec = reinterpret_cast<const float*>(smem_tc + pad +
                                                    (svec - sk));

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int c0 = blockIdx.y * 64;  // the first kv tiles have most q tiles
  const int lane = threadIdx.x & 31;
  const int row0 = c0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const E* dout = static_cast<const E*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse_g = p.lse_in + (long long)bh * p.Tq;
  const float* dlt_g = p.delta + (long long)bh * p.Tq;
  // q tile t (rows Q*t ..) into stage st: Q, dO, then lse and delta
  auto load_q = [&](int t, int st) {
    const int r = Q * t;
    load_tile<D>(sq + st * kQT, q, p.q_st, r, Q, p.Tq);
    load_tile<D>(sdo + st * kQT, dout, p.o_st, r, Q, p.Tq);
    if (threadIdx.x < 2 * Q) {
      const int row = r + threadIdx.x % Q;
      const bool ok = row < p.Tq;
      cp_async4(svec + 4 * (2 * Q * st + threadIdx.x),
                (threadIdx.x < Q ? lse_g : dlt_g) + (ok ? row : 0), ok);
    }
  };

  load_tile<D>(sk, k, p.k_st, c0, 64, p.Tk);
  load_tile<D>(sv, v, p.v_st, c0, 64, p.Tk);
  // causal: q tiles from the diagonal down (row >= col needs r + Q - 1 >= c0)
  const int first = p.causal ? c0 / Q : 0;
  const int n_q = (p.Tq + Q - 1) / Q;
  if (first < n_q) load_q(first, 0);
  cp_async_commit();
  const float scale2 = p.scale * kLog2e;

  float dk[D / 2], dv[D / 2], s[Q / 2], dp[Q / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int t = first; t < n_q; ++t) {
    const int r0 = Q * t, st = (t - first) % kStages;
    const uint32_t qt = sq + st * kQT, dot = sdo + st * kQT;
    const float* lse_s = vec + 2 * Q * st;
    const float* dlt_s = lse_s + Q;
    cp_async_wait_all();
    fence_proxy_async();
    // tile t is in; the stage tile t + 1 loads into was last read by tile
    // t - 2's dV and dK products, which the wait below S^T in tile t - 1
    // saw finish; tile t - 1's may still run
    __syncthreads();
    if (t + 1 < n_q) {
      load_q(t + 1, (st + 1) % kStages);
      cp_async_commit();
    }
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(s, desc_k(sk, 64, kk), desc_k(qt, Q, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(dp, desc_k(sv, 64, kk), desc_k(dot, Q, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // the last dV, dK and S^T are in; P^T, dV overlap dP^T
    fence_acc(s);
    const bool edge = (p.causal && r0 < c0 + 63) || r0 + Q > p.Tq ||
                      c0 + 64 > p.Tk;
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + col0 + e;  // q row within the tile
        const float l2 = lse_s[col] * kLog2e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          s[i] = ex2(fmaf(s[i], scale2, -l2));
          if (edge && !valid(r0 + col, row0 + 8 * hh, p.Tq, p.Tk, p.causal))
            s[i] = 0.f;
        }
      }
    uint32_t ap[Q / 16][4], ads[Q / 16][4];
    to_a<E>(s, ap);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      wgmma_rs<E>(dv, ap[kk], desc_mn(dot, Q, kk));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dV may still run
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dlt_s[8 * j + col0 + e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          dp[i] = s[i] * (dp[i] - dl) * p.scale;
        }
      }
    to_a<E>(dp, ads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      wgmma_rs<E>(dk, ads[kk], desc_mn(qt, Q, kk));
    wgmma_commit();  // waited for below the next tile's S^T
  }
  wgmma_wait<0>();
  cp_async_wait_all();  // K and V, when no q tile reaches this block
  fence_acc(dk);
  fence_acc(dv);
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<E*>(p.dk), dk, one, b, p.Tk, p.H, h, row0,
                col0);
  store_rows<D>(static_cast<E*>(p.dv), dv, one, b, p.Tk, p.H, h, row0,
                col0);
}

// Shared memory of each kernel, in bytes.
constexpr size_t kMaxSmem = 232448;  // what one block may ask for
template <int D>
constexpr size_t tile_t() {  // a transposed [D][kTile] float32 tile
  return (size_t)D * kTile * sizeof(float);
}
template <int D>
constexpr size_t tile_r() {  // a padded row-major [kTile][D + 4] one
  return (size_t)kTile * (D + 4) * sizeof(float);
}
constexpr size_t kTileP = (size_t)kTile * kPStride * sizeof(float);
constexpr size_t kRowVecs = 2 * kTile * sizeof(float);
template <int D>
constexpr size_t smem_fwd() {
  return 2 * tile_t<D>() + tile_r<D>() + kTileP;
}
template <int D>
constexpr size_t smem_dq() {
  return 4 * tile_t<D>() + tile_r<D>() + kTileP + kRowVecs;
}
template <int D>
constexpr size_t smem_dkv() {
  return 4 * tile_t<D>() + 2 * tile_r<D>() + kTileP + kRowVecs;
}
// the tensor-core kernels: 1 KB to align the base, the resident tiles,
// the stages of the streamed tiles (and for dK/dV their lse and delta)
template <int D>
constexpr size_t smem_fwd_tc() {
  return 1024 + (1 + kStagesFirst + kStages) * (size_t)tc_tile<D>(64);
}
template <int D>
constexpr size_t smem_dq_tc() {
  return 1024 + (2 + kStages + kStagesFirst) * (size_t)tc_tile<D>(64);
}
template <int D>
constexpr size_t smem_dkv_tc() {
  return 1024 + 2 * (size_t)tc_tile<D>(64) +
         kStages * (2 * (size_t)tc_tile<D>(dkv_q_rows<D>()) +
                    2 * dkv_q_rows<D>() * sizeof(float));
}
static_assert(smem_dkv<128>() <= kMaxSmem && smem_dq<128>() <= kMaxSmem &&
                  smem_fwd<128>() <= kMaxSmem &&
                  smem_dq_tc<128>() <= kMaxSmem &&
                  smem_fwd_tc<128>() <= kMaxSmem &&
                  smem_dkv_tc<128>() <= kMaxSmem,
              "a kernel asks for more shared memory than a block has");

// One block per (batch * head, tile of `rows` rows of T).
template <typename K>
cudaError_t launch(K kernel, size_t smem, int threads, int rows, int B,
                   int H, int T, const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (T + rows - 1) / rows);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernel of each pass for head dim D and dtype code (0 = float32 on
// the CUDA cores, 1 = bfloat16 and 2 = float16 on the tensor cores).
template <int D>
cudaError_t run_fwd(const Params& p, int B, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch(flash_fwd_kernel<D>, smem_fwd<D>(), kThreads, kTile, B,
                  p.H, p.Tq, p, s);
  if (dtype == 1)
    return launch(flash_fwd_tc_kernel<D, __nv_bfloat16>, smem_fwd_tc<D>(),
                  kTcThreads, 64, B, p.H, p.Tq, p, s);
  if (dtype == 2)
    return launch(flash_fwd_tc_kernel<D, __half>, smem_fwd_tc<D>(),
                  kTcThreads, 64, B, p.H, p.Tq, p, s);
  return cudaErrorInvalidValue;
}
template <int D>
cudaError_t run_dq(const Params& p, int B, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch(flash_dq_kernel<D>, smem_dq<D>(), kThreads, kTile, B, p.H,
                  p.Tq, p, s);
  if (dtype == 1)
    return launch(flash_dq_tc_kernel<D, __nv_bfloat16>, smem_dq_tc<D>(),
                  kTcThreads, 64, B, p.H, p.Tq, p, s);
  if (dtype == 2)
    return launch(flash_dq_tc_kernel<D, __half>, smem_dq_tc<D>(),
                  kTcThreads, 64, B, p.H, p.Tq, p, s);
  return cudaErrorInvalidValue;
}
template <int D>
cudaError_t run_dkv(const Params& p, int B, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch(flash_dkv_kernel<D>, smem_dkv<D>(), kThreads, kTile, B,
                  p.H, p.Tk, p, s);
  if (dtype == 1)
    return launch(flash_dkv_tc_kernel<D, __nv_bfloat16>, smem_dkv_tc<D>(),
                  kTcThreads, 64, B, p.H, p.Tk, p, s);
  if (dtype == 2)
    return launch(flash_dkv_tc_kernel<D, __half>, smem_dkv_tc<D>(),
                  kTcThreads, 64, B, p.H, p.Tk, p, s);
  return cudaErrorInvalidValue;
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
  bool built = false;
  for (int d : kHeadDims) built = built || head_dim == d;
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || !built ||
         (long long)B * H > 0x7fffffffLL ||
         (Tq + kTile - 1) / kTile > 65535 || (Tk + kTile - 1) / kTile > 65535;
}

}  // namespace

extern "C" {

// The head dims the kernels are built for: writes up to n of them into
// dims and returns how many there are.
int flash_attention_head_dims(int* dims, int n) {
  const int count = sizeof(kHeadDims) / sizeof(kHeadDims[0]);
  for (int i = 0; i < count && i < n; ++i) dims[i] = kHeadDims[i];
  return count;
}

// strides: 12 element strides, (batch, seq, head) of q, k, v and dO in
// that order (dO's are ignored by the forward). head_dim: 64 or 128.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16; it picks the design:
// float32 on the CUDA cores, bfloat16 and float16 on the tensor cores. Each returns a cudaError_t
// value (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, const long long* strides,
                        int B, int H, int Tq, int Tk, int head_dim,
                        float scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, H, Tq, Tk, head_dim)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, strides, H, Tq, Tk, scale, causal);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(head_dim == 64 ? run_fwd<64>(p, B, dtype, s)
                              : run_fwd<128>(p, B, dtype, s));
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
  return (int)(head_dim == 64 ? run_dq<64>(p, B, dtype, s)
                              : run_dq<128>(p, B, dtype, s));
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
  return (int)(head_dim == 64 ? run_dkv<64>(p, B, dtype, s)
                              : run_dkv<128>(p, B, dtype, s));
}

}  // extern "C"
