// Ragged paged attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_kernel` (launched by the pallas_call in `ragged_paged_attention`).
// One launch attends a batch of query tokens that mixes decode tokens
// and prefill-chunk tokens of different sequences. For every token t
// with page-table row r = token_seq[t]:
//
//   out[t, h] = softmax_{j < bounds[t]}(q[t, h] . K_r[j, h / fold] * scale)
//               . V_r[j, h / fold]
//
// K_r / V_r are read through page_table[r] from the pools
// [n_pages, P, H_kv, D]; fold = H / H_kv (grouped-query attention). The
// softmax is online in float32 with the finite mask value -1e30, and
// probabilities outside the bound are zeroed explicitly, so a pad token
// (bound 0) does no work and its output is exactly 0. The kernel also
// writes work[t] = the number of kv pages it computed for t, which is
// ceil(bounds[t] / P), or 0 for a pad.
//
// What bounds it on the card: reading K/V pages. Every token of a
// serving step attends over its whole history, at about 4 flops per
// byte of K/V read (bf16), far below the H100's ~295 flops/byte ridge,
// so the least time is the K/V bytes the step needs over 3.35 TB/s.
// What the design does about it:
//   - a thread block owns up to kMaxRows query rows of ONE kv head:
//     `tokens_per_block` consecutive tokens times the `fold` query
//     heads sharing that kv head. Rows of the same sequence (a prefill
//     chunk, a GQA group) share every page the block loads, so a page
//     is read once per block and not once per token or per head;
//   - the block's page walk (the distinct rows of its tokens, each up
//     to the largest bound among its tokens) is dealt out round-robin
//     to its 8 warps, which walk independently: a decode token's long
//     history streams through 8 concurrent page loads per block;
//   - a warp stages a page through shared memory with 16-byte loads,
//     all of a page's loads issued before the first store, so a page
//     costs one memory round trip; rows are padded to an odd number of
//     32-bit words so that the one-key-per-lane score reads hit 32
//     different banks;
//   - each warp keeps its rows' running max, sum and output in
//     registers; the warps' partial results merge once at the end.
// Not done yet (later work): cp.async/TMA double buffering of pages,
// tensor-core (wgmma) score and value products, and splitting one
// decode token's history across thread blocks when a step has too few
// tokens to fill the 132 SMs.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes
// (ops/kernels/paged_attention.py). It launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;       // query rows (token x folded head)
constexpr int kMeta = 6 * kMaxRows;  // per-block int bookkeeping
constexpr int kLoadBatch = 4;      // 16-byte page loads in flight per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared-memory row stride of a staged page, in elements: D plus one
// 32-bit word, so consecutive rows start in different banks.
template <typename scalar_t, int D>
struct Layout {
  static constexpr int kStride = D + 4 / (int)sizeof(scalar_t);
  static constexpr int kVec = 16 / (int)sizeof(scalar_t);  // per 16 B
  static constexpr int kChunks = D / kVec;                 // per row
  static constexpr int kPerLane = D / 32;                  // out dims
};

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const scalar_t* __restrict__ q, const scalar_t* __restrict__ k_pages,
    const scalar_t* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ token_seq, const int* __restrict__ bounds,
    scalar_t* __restrict__ out, int* __restrict__ work, int n_tokens,
    int n_heads, int n_kv_heads, int n_pages, int P, int n_rows, int W,
    int tokens_per_block, float scale) {
  using L = Layout<scalar_t, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);            // [kMaxRows][D]
  int* meta = reinterpret_cast<int*>(q_s + kMaxRows * D);
  int* tok_row = meta;                     // [kMaxRows] row or -1 (pad)
  int* tok_bound = meta + kMaxRows;        // [kMaxRows]
  int* work_s = meta + 2 * kMaxRows;       // [kMaxRows]
  int* walk_row = meta + 3 * kMaxRows;     // [kMaxRows] distinct rows
  int* walk_off = meta + 4 * kMaxRows;     // [kMaxRows + 1] slot offsets
  int* walk_n = meta + 5 * kMaxRows + 1;   // distinct row count
  unsigned char* region = reinterpret_cast<unsigned char*>(meta + kMeta);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kvh = blockIdx.y;
  const int fold = n_heads / n_kv_heads;
  const int t0 = blockIdx.x * tokens_per_block;
  const int n_tok = min(tokens_per_block, n_tokens - t0);
  const int R = n_tok * fold;

  // this block's query rows, pre-scaled, in float32
  for (int i = tid; i < R * D; i += kThreads) {
    const int m = i / D, d = i - m * D;
    const int tk = m / fold;
    const int h = kvh * fold + (m - tk * fold);
    q_s[i] = to_f32(q[((size_t)(t0 + tk) * n_heads + h) * D + d]) * scale;
  }
  if (tid < n_tok) {
    int r = token_seq[t0 + tid];
    int b = bounds[t0 + tid];
    if (r < 0 || r >= n_rows || b <= 0) {  // pad (or out-of-range) token
      r = -1;
      b = 0;
    }
    tok_row[tid] = r;
    tok_bound[tid] = b;
    work_s[tid] = 0;
  }
  __syncthreads();

  // the page walk: each distinct row of the block's tokens, up to the
  // largest bound among them (at most W pages of its table)
  if (tid == 0) {
    int nr = 0, off = 0;
    for (int i = 0; i < n_tok; ++i) {
      const int r = tok_row[i];
      bool seen = r < 0;
      for (int j = 0; j < i && !seen; ++j) seen = tok_row[j] == r;
      if (seen) continue;
      int bmax = 0;
      for (int j = i; j < n_tok; ++j)
        if (tok_row[j] == r) bmax = max(bmax, tok_bound[j]);
      walk_row[nr] = r;
      walk_off[nr] = off;
      off += min((bmax + P - 1) / P, W);
      ++nr;
    }
    walk_off[nr] = off;
    *walk_n = nr;
  }
  __syncthreads();

  float m_r[kMaxRows], l_r[kMaxRows], acc[kMaxRows][L::kPerLane];
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m) {
    m_r[m] = kNegInf;
    l_r[m] = 0.f;
#pragma unroll
    for (int k = 0; k < L::kPerLane; ++k) acc[m][k] = 0.f;
  }

  scalar_t* kb = reinterpret_cast<scalar_t*>(region) +
                 (size_t)warp * 2 * P * L::kStride;
  scalar_t* vb = kb + (size_t)P * L::kStride;
  const int n_slots = walk_off[*walk_n];
  int wi = 0;
  for (int s = warp; s < n_slots; s += kWarps) {
    while (s >= walk_off[wi + 1]) ++wi;
    const int r = walk_row[wi];
    const int j = s - walk_off[wi];
    const int start = j * P;
    const int page = page_table[(size_t)r * W + j];
    if (page < 0 || page >= n_pages) continue;  // never read out of bounds

    // stage page `page` of kv head `kvh` (P rows of D) into this warp's
    // buffers: 16-byte global loads, 32-bit shared stores
    __syncwarp();
    const size_t row_stride = (size_t)n_kv_heads * D;
    const scalar_t* kg = k_pages + ((size_t)page * P * n_kv_heads + kvh) * D;
    const scalar_t* vg = v_pages + ((size_t)page * P * n_kv_heads + kvh) * D;
    const int n_chunks = P * L::kChunks;
    for (int base = 0; base < n_chunks; base += 32 * kLoadBatch) {
      // issue kLoadBatch K and V loads per lane before storing any, so
      // they are in flight together (one memory round trip, not many)
      uint4 kk[kLoadBatch], vv[kLoadBatch];
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        const int c = base + i * 32 + lane;
        if (c < n_chunks) {
          const int p = c / L::kChunks, x = c - p * L::kChunks;
          kk[i] = *reinterpret_cast<const uint4*>(kg + p * row_stride +
                                                  x * L::kVec);
          vv[i] = *reinterpret_cast<const uint4*>(vg + p * row_stride +
                                                  x * L::kVec);
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        const int c = base + i * 32 + lane;
        if (c < n_chunks) {
          const int p = c / L::kChunks, x = c - p * L::kChunks;
          uint32_t* kd =
              reinterpret_cast<uint32_t*>(kb + p * L::kStride + x * L::kVec);
          uint32_t* vd =
              reinterpret_cast<uint32_t*>(vb + p * L::kStride + x * L::kVec);
          kd[0] = kk[i].x; kd[1] = kk[i].y; kd[2] = kk[i].z; kd[3] = kk[i].w;
          vd[0] = vv[i].x; vd[1] = vv[i].y; vd[2] = vv[i].z; vd[3] = vv[i].w;
        }
      }
    }
    __syncwarp();

#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) {
      if (m < R) {
        const int tk = m / fold;
        const int bound = tok_bound[tk];
        if (tok_row[tk] == r && start < bound) {  // warp-uniform
          if (lane == 0 && m - tk * fold == 0) atomicAdd(&work_s[tk], 1);
          const float* qrow = q_s + m * D;
          for (int c0 = 0; c0 < P; c0 += 32) {
            const int key = c0 + lane;
            const bool valid = key < P && start + key < bound;
            float sc = kNegInf;
            if (valid) {
              // four partial sums: independent FMA chains
              const scalar_t* krow = kb + key * L::kStride;
              float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
              for (int d = 0; d < D; d += 4) {
                a0 += qrow[d] * to_f32(krow[d]);
                a1 += qrow[d + 1] * to_f32(krow[d + 1]);
                a2 += qrow[d + 2] * to_f32(krow[d + 2]);
                a3 += qrow[d + 3] * to_f32(krow[d + 3]);
              }
              sc = (a0 + a1) + (a2 + a3);
            }
            const float m_new = fmaxf(m_r[m], warp_max(sc));
            const float p = valid ? __expf(sc - m_new) : 0.f;
            const float alpha = __expf(m_r[m] - m_new);
            l_r[m] = l_r[m] * alpha + warp_sum(p);
#pragma unroll
            for (int k = 0; k < L::kPerLane; ++k) acc[m][k] *= alpha;
            const int nk = min(32, P - c0);
            for (int jj = 0; jj < nk; ++jj) {
              const float pj = __shfl_sync(kFull, p, jj);
              const scalar_t* vrow = vb + (c0 + jj) * L::kStride;
#pragma unroll
              for (int k = 0; k < L::kPerLane; ++k)
                acc[m][k] += pj * to_f32(vrow[lane + 32 * k]);
            }
            m_r[m] = m_new;
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states (the page buffers are dead)
  __syncthreads();
  float* m_buf = reinterpret_cast<float*>(region);  // [kWarps][kMaxRows]
  float* l_buf = m_buf + kWarps * kMaxRows;
  float* a_buf = l_buf + kWarps * kMaxRows;         // [kWarps][kMaxRows][D]
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m) {
    if (m < R) {
      if (lane == 0) {
        m_buf[warp * kMaxRows + m] = m_r[m];
        l_buf[warp * kMaxRows + m] = l_r[m];
      }
#pragma unroll
      for (int k = 0; k < L::kPerLane; ++k)
        a_buf[(warp * kMaxRows + m) * D + lane + 32 * k] = acc[m][k];
    }
  }
  __syncthreads();
  for (int m = warp; m < R; m += kWarps) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_buf[w * kMaxRows + m]);
    float l = 0.f, o[L::kPerLane];
#pragma unroll
    for (int k = 0; k < L::kPerLane; ++k) o[k] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      // a warp that never touched the row holds (-1e30, 0, 0): its
      // weight is 0, or 1 times nothing when no warp did (a pad row)
      const float e = __expf(m_buf[w * kMaxRows + m] - mx);
      l += l_buf[w * kMaxRows + m] * e;
#pragma unroll
      for (int k = 0; k < L::kPerLane; ++k)
        o[k] += a_buf[(w * kMaxRows + m) * D + lane + 32 * k] * e;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);  // pad rows: 0 * 1e30 = 0
    const int tk = m / fold;
    const int h = kvh * fold + (m - tk * fold);
    scalar_t* orow = out + ((size_t)(t0 + tk) * n_heads + h) * D;
#pragma unroll
    for (int k = 0; k < L::kPerLane; ++k) store(orow + lane + 32 * k, o[k] * inv);
  }
  if (blockIdx.y == 0 && tid < n_tok) work[t0 + tid] = work_s[tid];
}

template <typename scalar_t, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* token_seq,
                   const void* bounds, void* out, void* work, int n_tokens,
                   int n_heads, int n_kv_heads, int n_pages, int P,
                   int n_rows, int W, int tokens_per_block, float scale,
                   cudaStream_t stream) {
  using L = Layout<scalar_t, D>;
  const size_t kv = (size_t)kWarps * 2 * P * L::kStride * sizeof(scalar_t);
  const size_t merge =
      (size_t)(2 * kWarps * kMaxRows + kWarps * kMaxRows * D) * sizeof(float);
  const size_t smem = (size_t)kMaxRows * D * sizeof(float) +
                      kMeta * sizeof(int) + (kv > merge ? kv : merge);
  auto kernel = ragged_paged_attention_kernel<scalar_t, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n_tokens + tokens_per_block - 1) / tokens_per_block,
                  n_kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k_pages),
      static_cast<const scalar_t*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(token_seq),
      static_cast<const int*>(bounds), static_cast<scalar_t*>(out),
      static_cast<int*>(work), n_tokens, n_heads, n_kv_heads, n_pages, P,
      n_rows, W, tokens_per_block, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Query rows (tokens_per_block * fold) one thread block can hold.
int paged_attention_max_rows() { return kMaxRows; }

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// head_dim: 64 or 128. Returns a cudaError_t value (0 = launched).
int paged_attention_ragged(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* token_seq, const void* bounds,
                           void* out, void* work, int n_tokens, int n_heads,
                           int n_kv_heads, int head_dim, int n_pages,
                           int page_size, int n_rows, int table_width,
                           int tokens_per_block, float scale, int dtype,
                           void* stream) {
  if (n_tokens <= 0) return (int)cudaSuccess;
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || page_size <= 0 ||
      tokens_per_block < 1 ||
      tokens_per_block * (n_heads / n_kv_heads) > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(T, D)                                                      \
  launch<T, D>(q, k_pages, v_pages, page_table, token_seq, bounds, out,     \
               work, n_tokens, n_heads, n_kv_heads, n_pages, page_size,     \
               n_rows, table_width, tokens_per_block, scale, s)
  cudaError_t e;
  if (dtype == 0 && head_dim == 64) e = PA_LAUNCH(float, 64);
  else if (dtype == 0 && head_dim == 128) e = PA_LAUNCH(float, 128);
  else if (dtype == 1 && head_dim == 64) e = PA_LAUNCH(__nv_bfloat16, 64);
  else if (dtype == 1 && head_dim == 128) e = PA_LAUNCH(__nv_bfloat16, 128);
  else e = cudaErrorInvalidValue;
#undef PA_LAUNCH
  return (int)e;
}

}  // extern "C"
