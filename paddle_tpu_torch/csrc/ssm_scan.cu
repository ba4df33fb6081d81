// Ragged selective scan (Mamba SSM) for NVIDIA Hopper (sm_90a), CUDA C++:
// kernel #11.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ssm_scan.py `_scan_kernel`
// (launched by the pallas_call in `ssm_scan`). One launch advances a batch
// of tokens whose rows belong to different sequences, decode rows and
// prefill chunks mixed. For token t with row r = token_seq[t], over the
// states h [R, D, N] (float32 throughout):
//
//   h_r[d, n] <- exp(dt[t, d] * A[d, n]) * h_r[d, n]
//                + (dt[t, d] * x[t, d]) * B[t, n]
//   y[t, d]    = sum_n h_r[d, n] * C[t, n]
//
// then every row's final state is written to h_out. Rows may interleave:
// each row's tokens are applied in stream order. Pads carry dt = 0, an
// identity update (exp(0) = 1, the input term 0). A token whose row lies
// outside [0, R) reads a zero state and writes none, as the reference's
// one-hot row select does.
//
// What bounds it on the card. Bytes: x, dt and y ([T, D]), h0 and h_out
// ([R, D, N]), A, B, C and token_seq once each: at serving shapes
// (D 1536, N 16, R 8) about 1.8 MB at T = 8 (0.54 us at 3.35 TB/s) and
// 6.4 MB at T = 256 (1.9 us). Operations: an exponential, two multiplies
// and three fused multiply-adds per state element per token, with a
// scan's share on top; the full causal forward of 4 x 1024 tokens at that
// width has ~1e8 state elements. In practice latency bounds the served
// steps, not bytes: a block's dependent memory round trips, barriers,
// shuffles and the chain of one thread's instructions, at one to three
// blocks an SM.
// The recurrence is a chain along each row's time axis; it is associative,
// (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2), so the chain is scanned in
// parallel (the design of the public Mamba selective-scan forward kernel).
//
// The design:
//   - rows apart: the grid is (R + 1) x ceil(D / gc) blocks, one per
//     (row, group of gc channels); block row R takes the tokens whose row
//     lies outside [0, R). A block gathers its row's token indices, in
//     stream order, into shared memory from token_seq itself (a stable
//     compaction, `kWindow` tokens a thread a pass): no host work and no
//     schedule in device memory, so any T fits. Each block reads all of
//     token_seq: (R + 1) x groups x T reads a call.
//   - a row of at most kBatch tokens (decode rows, an untouched row)
//     takes no scan: one thread per (channel, state column) holds the
//     state in a register and walks the tokens, their inputs staged in
//     shared memory by cp.async, summing y over the column lanes by warp
//     shuffles; an untouched row copies h0.
//   - a stream of at most kBatch tokens (the decode step) runs a kernel of
//     its own, `ssm_decode_kernel`: a block takes kMaxGroup rows of a
//     channel group, their states in registers; the stream's inputs are
//     staged by cp.async all at once and each token's h C summed in
//     shared memory, so the block waits on memory once.
//   - a longer row is scanned along time: thread (slice s, channel) holds
//     up to L consecutive tokens of the block's chunk (slices x L tokens;
//     their B and C rows, dt and x are staged in shared memory by cp.async
//     in pieces of 16 bytes, the next chunk's while the list is compacted
//     when its tokens are gathered already) and goes over the N state
//     columns kCols at a time. For each pass it forms exp(dt A) and (dt x)
//     B once per (token, column) in registers, folds them in order (a
//     thread-local walk), scans the folds across the warp's slices by
//     shuffles and across warps through shared memory (one barrier a
//     pass), applies the prefix to the state carried in from the last
//     chunk and walks its tokens again from there, summing y_t = sum_n
//     h_t[n] C_t[n] in registers. The last slice's state is the carry of
//     the next chunk, then h_out. Each thread's walk stays sequential:
//     the arithmetic is reordered only across threads.
//   - pads (dt = 0) are identities and take no arithmetic but y's: the
//     state passes them unchanged, so a row that only pads touch keeps its
//     state bit for bit. A row gathered whole drops its trailing pads (the
//     engine's pads, at the end of a step) from the scan: their y is the
//     final state's h C.
// exp(dt A) is 2^(dt A log2 e) by ex2.approx (kFastExp; expf when 0),
// as the Mamba kernel forms it with exp2f; with nvcc's fused
// multiply-adds and the reordered scan, y and h stay within the twin's
// tolerance (1e-5) of the plain twin (ops/kernels/ssm_scan.py).
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes. It launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;              // threads of a scan block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks an SM ptxas keeps registers for
constexpr int kWindow = 8;                 // token_seq entries a thread a pass
// tokens a short-row walk stages at once; rows of at most kBatch tokens
// take no scan, and a stream of at most kBatch tokens runs the decode
// kernel
constexpr int kBatch = 8;
constexpr int kMaxGroup = 2;               // rows a decode block holds
constexpr int kCols = 4;                   // state columns a scan pass
constexpr int kMaxState = 32;              // d_state at most
// exp(dt A) as 2^(dt A log2(e)) by the SFU's ex2.approx (as the public
// Mamba kernel forms it with exp2f), or by expf (0)
constexpr int kFastExp = 1;
constexpr size_t kMaxSmem = 232448;        // a Hopper block's shared memory
constexpr size_t kDefaultSmem = 48 * 1024;  // without the opt-in attribute

__host__ __device__ inline int lanes_of(int N) {
  int l = 1;
  while (l < N) l <<= 1;
  return l;
}

// Row strides of a chunk's staged inputs, in floats: B and C rows (N
// rounded up to 4, plus 4) and dt and x rows (gc rounded up to 4), so that
// every row starts on 16 bytes and the warp's slices read different banks.
__host__ __device__ inline int stride_bc(int N) { return (N + 3) / 4 * 4 + 4; }
__host__ __device__ inline int stride_dx(int gc) { return (gc + 3) / 4 * 4; }

// Shared memory of a block, in 4-byte words: the chunk's B and C rows, dt
// and x of its tokens (16-byte aligned, first), the row's token list (a
// chunk plus one gather pass), one int a warp, A of the block's channels,
// the carried states (two buffers), the warps' folds (two buffers), and a
// short row's batch: its B, C, dt, x and the row's h0.
__host__ __device__ inline size_t smem_words(int gc, int L, int N) {
  const size_t chunk = kThreads / gc * L, cs = N | 1;
  return 2 * chunk * stride_bc(N) + 2 * chunk * stride_dx(gc) + chunk +
         size_t(kThreads) * kWindow + kWarps + 3 * size_t(gc) * cs +
         2 * size_t(kWarps) * gc * 2 * kCols +
         kBatch * (2 * cs + 2 * size_t(gc + 1)) + size_t(gc) * cs;
}

// A as the exponent's factor: A log2(e) for ex2, A for expf
__device__ __forceinline__ float exp_factor(float a) {
  return kFastExp ? a * 1.4426950408889634f : a;
}

// exp(dt A) from dt and exp_factor(A); dt = 0 (a pad) gives 1 exactly
__device__ __forceinline__ float exp_dt(float dt, float af) {
  if (dt == 0.f) return 1.f;
  if (!kFastExp) return expf(dt * af);
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dt * af));
  return r;
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

// What a block shares.
struct Block {
  int *list, *wsum;
  float *bs, *cs_, *dts, *xs, *as, *carry, *wagg;
  float *wb, *wc, *wdt, *wx, *wh;  // a short-row batch
  int T, D, N, R, gc, cs, rb, rg, lane, warp, d0;
  bool vec;  // the chunk's inputs are copied 16 bytes at a time
  int row, pos, have;  // the block's row and its gather
};

// ---- the row's tokens, gathered a pass at a time --------------------------

__device__ __forceinline__ bool of_row(int v, int row, int R) {
  return row < R ? v == row : (v < 0 || v >= R);
}

// Append the row's next token indices to the list until it holds `want`
// or the stream ends. Block-uniform; every thread calls it.
__device__ void fill(Block& k, const int* __restrict__ seq, int want) {
  const int tid = threadIdx.x;
  while (k.have < want && k.pos < k.T) {
    // a stable compaction of kWindow consecutive entries a thread
    const int base = k.pos + tid * kWindow;
    int v[kWindow];
#pragma unroll
    for (int j = 0; j < kWindow; ++j)
      v[j] = base + j < k.T ? __ldg(seq + base + j) : INT_MIN;
    unsigned hits = 0;
#pragma unroll
    for (int j = 0; j < kWindow; ++j)
      if (base + j < k.T && of_row(v[j], k.row, k.R)) hits |= 1u << j;
    const int cnt = __popc(hits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (k.lane >= o) incl += u;
    }
    if (k.lane == 31) k.wsum[k.warp] = incl;
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int u = k.wsum[w];
      off += w < k.warp ? u : 0;
      total += u;
    }
    int at = k.have + off + incl - cnt;
    for (int j = 0; hits; ++j, hits >>= 1)
      if (hits & 1u) k.list[at++] = base + j;
    __syncthreads();  // the list is whole; wsum may be written again
    k.have += total;
    k.pos += kThreads * kWindow;
  }
}

// Drop the first m entries of the list (at most one pass's worth stay).
__device__ void drop(Block& k, int m) {
  const int tid = threadIdx.x, left = k.have - m;
  int v[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int i = tid + j * kThreads;
    v[j] = i < left ? k.list[m + i] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int i = tid + j * kThreads;
    if (i < left) k.list[i] = v[j];
  }
  __syncthreads();
  k.have = left;
}

// ---- short rows: no scan --------------------------------------------------

// Walk n tokens toks[0, n) of `row` with no scan: thread (channel, column)
// holds the state in a register and applies the tokens in order; y sums
// over the channel's column lanes by shuffles. Row R stands for the
// tokens outside [0, R): each starts from a zero state and writes none.
// kBatch tokens at a time, their inputs (and, first, the row's h0) are
// copied into shared memory with all copies in flight at once, then walked
// by a rolled loop; the final state goes to h_out, or with `state` to
// shared memory, channel ch at state + ch cs. Needs gc x lanes <= threads.
__device__ void walk_short(const Block& k, const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ b,
                           const float* __restrict__ c,
                           const float* __restrict__ a,
                           const float* __restrict__ h0, float* __restrict__ y,
                           float* __restrict__ h_out, const int* toks, int n,
                           int row, float* state = nullptr) {
  const int D = k.D, N = k.N, gc = k.gc, cs = k.cs;
  const int lanes = lanes_of(N);
  const int p = threadIdx.x, ch = p / lanes, col = p % lanes, d = k.d0 + ch;
  const bool live = p < gc * lanes && col < N && d < D;
  const bool inside = row < k.R;
  const size_t DN = static_cast<size_t>(D) * N;
  const size_t dn = static_cast<size_t>(d) * N + col;
  const int nch = min(gc, D - k.d0);
  const float an = live ? exp_factor(__ldg(a + dn)) : 0.f;
  if (inside && n)
    for (int q = threadIdx.x; q < nch * N; q += kThreads)
      copy4(k.wh + (q / N) * cs + q % N,
            h0 + row * DN + size_t(k.d0) * N + q);
  float h = 0.f;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    const int nb = min(kBatch, n - i0);
    for (int u = k.warp; u < nb; u += kWarps) {
      const int t = toks[i0 + u];
      for (int q = k.lane; q < N; q += 32) {
        copy4(k.wb + u * cs + q, b + static_cast<size_t>(t) * N + q);
        copy4(k.wc + u * cs + q, c + static_cast<size_t>(t) * N + q);
      }
      for (int q = k.lane; q < nch; q += 32) {
        copy4(k.wdt + u * (gc + 1) + q,
              dt + static_cast<size_t>(t) * D + k.d0 + q);
        copy4(k.wx + u * (gc + 1) + q,
              x + static_cast<size_t>(t) * D + k.d0 + q);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (i0 == 0 && inside && live) h = k.wh[ch * cs + col];
#pragma unroll 1
    for (int u = 0; u < nb; ++u) {
      float v = 0.f;
      if (live) {
        const float dtv = k.wdt[u * (gc + 1) + ch];
        const float dbx = (dtv * k.wx[u * (gc + 1) + ch]) * k.wb[u * cs + col];
        const float hn = fmaf(exp_dt(dtv, an), inside ? h : 0.f, dbx);
        if (inside) h = hn;
        v = hn * k.wc[u * cs + col];
      }
      for (int o = lanes / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (live && col == 0) y[static_cast<size_t>(toks[i0 + u]) * D + d] = v;
    }
    __syncthreads();  // the batch's buffers are free
  }
  if (inside && live) {
    const float hf = n ? h : h0[row * DN + dn];
    if (state)
      state[ch * cs + col] = hf;
    else
      h_out[row * DN + dn] = hf;
  }
}

// ---- long rows: scanned along time ---------------------------------------

// Issue the copies of a chunk's inputs into shared memory: B and C of its
// tokens toks[0, m), dt and x at the block's channels, token j in slot
// (j % lr) slices + j / lr, lr = ceil(m / slices), so that the slices of a
// warp read consecutive slots. A token's inputs are `per` pieces of 16
// bytes (k.vec) or 4; thread i copies piece i % per of every (kThreads /
// per)-th token from token i / per on. With `h0_row` >= 0 also that row's
// state into carry buffer 0.
__device__ void stage_chunk(const Block& k, const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ b,
                            const float* __restrict__ c,
                            const float* __restrict__ h0, const int* toks,
                            int m, int slices, int h0_row) {
  const int gc = k.gc, N = k.N, cs = k.cs, D = k.D;
  const int w = k.vec ? 4 : 1;  // floats a piece
  const int pn = N / w, pg = (gc + w - 1) / w, per = 2 * pn + 2 * pg;
  const int every = kThreads / per, r = threadIdx.x % per;
  const float* src;  // this thread's piece of token 0
  float* dst;        // and of slot 0
  size_t src_row;
  int dst_row;
  bool on = static_cast<int>(threadIdx.x) < every * per;
  if (r < 2 * pn) {  // B, then C
    const int q = (r < pn ? r : r - pn) * w;
    src = (r < pn ? b : c) + q;
    dst = (r < pn ? k.bs : k.cs_) + q;
    src_row = N;
    dst_row = k.rb;
  } else {  // dt, then x
    const int q = (r - 2 * pn < pg ? r - 2 * pn : r - 2 * pn - pg) * w;
    on = on && k.d0 + q < D;
    src = (r - 2 * pn < pg ? dt : x) + k.d0 + q;
    dst = (r - 2 * pn < pg ? k.dts : k.xs) + q;
    src_row = D;
    dst_row = k.rg;
  }
  if (on) {
    const int lr = (m + slices - 1) / slices;
    // j / lr by a float product: exact, the quotient's fraction being at
    // least 1 / (2 lr) away from an integer
    const float inv = 1.f / static_cast<float>(lr);
    for (int j = threadIdx.x / per; j < m; j += every) {
      const int sl = static_cast<int>((j + 0.5f) * inv), i = j - sl * lr;
      float* d = dst + (i * slices + sl) * dst_row;
      const float* s = src + toks[j] * src_row;
      if (k.vec)
        copy16(d, s);
      else
        copy4(d, s);
    }
  }
  if (h0_row >= 0) {
    const size_t at = h0_row * (static_cast<size_t>(D) * N) +
                      static_cast<size_t>(k.d0) * N;
    for (int i = threadIdx.x; i < gc * N; i += kThreads) {
      const int ch = i / N;
      if (k.d0 + ch < D) copy4(k.carry + ch * cs + i % N, h0 + at + i);
    }
  }
  __pipeline_commit();
}

// Where the row's trailing pads begin in its list (wholly gathered): the
// tokens after the last one with a nonzero dt at some channel of the
// block. The state passes them unchanged, so they take no scan; their y
// comes from the final state. Block-uniform; every thread calls it.
__device__ int trailing_pads(const Block& k, const float* __restrict__ dt) {
  const int nch = min(k.gc, k.D - k.d0);
  int end = 0;
  for (int top = k.have; top > 0 && end == 0; top -= kThreads) {
    const int j = top - 1 - static_cast<int>(threadIdx.x);
    bool real = false;
    if (j >= 0) {
      const float* p = dt + static_cast<size_t>(k.list[j]) * k.D + k.d0;
      for (int cc = 0; cc < nch; ++cc) real = real || __ldg(p + cc) != 0.f;
    }
    if (threadIdx.x == 0) k.wsum[0] = 0;
    __syncthreads();
    if (real) atomicMax(k.wsum, j + 1);
    __syncthreads();
    end = k.wsum[0];
    __syncthreads();  // wsum may be written again
  }
  return end;
}

// One chunk toks[0, m) of a long row, its inputs staged (stage_chunk):
// thread (slice s, channel ch) takes the chunk's tokens [s * lr, s * lr +
// lr), lr = ceil(m / slices) <= L, token s lr + i in slot i slices + s;
// carry_in holds the state entering the chunk, carry_out gets the state
// leaving it. The state columns go kCols
// at a time: per pass, each thread folds its tokens' (exp(dt A), (dt x) B)
// pairs in order, the folds are scanned across the warp's slices by
// shuffles and across warps through shared memory, and each thread walks
// its tokens again from its prefix, adding h C to y.
template <int L>
__device__ void scan_chunk(const Block& k, float* __restrict__ y,
                           const int* toks, int m, int ch, int s, int slices,
                           const float* carry_in, float* carry_out,
                           int& step) {
  const int gc = k.gc, N = k.N, cs = k.cs, d = k.d0 + ch;
  const int lr = (m + slices - 1) / slices;
  const bool dlive = d < k.D;
  __pipeline_wait_prior(0);
  __syncthreads();  // the chunk's inputs (and the carry) are staged
  int jt[L];  // the chunk's token, -1 past its end
  float dtv[L], dtx[L], yv[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int j = s * lr + i, slot = i * slices + s;
    jt[i] = dlive && i < lr && j < m ? j : -1;
    dtv[i] = dtx[i] = yv[i] = 0.f;
    if (jt[i] >= 0) {
      dtv[i] = k.dts[slot * k.rg + ch];
      dtx[i] = dtv[i] * k.xs[slot * k.rg + ch];
    }
  }
  const int sl = k.lane / gc;          // slice within the warp
  const int last_sl = 32 / gc - 1;
  for (int n0 = 0; n0 < N; n0 += kCols, ++step) {
    float an[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      an[q] = n0 + q < N ? exp_factor(k.as[ch * cs + n0 + q]) : 0.f;
    float av[L][kCols], bv[L][kCols], P[kCols], S[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      P[q] = 1.f;
      S[q] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      // pads (dt = 0) are identities, (1, 0): they take no arithmetic
      if (jt[i] < 0 || dtv[i] == 0.f) continue;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        float da = 1.f, dbx = 0.f;
        if (n0 + q < N) {
          da = exp_dt(dtv[i], an[q]);
          dbx = dtx[i] * k.bs[(i * slices + s) * k.rb + n0 + q];
        }
        av[i][q] = da;
        bv[i][q] = dbx;
        S[q] = fmaf(da, S[q], dbx);
        P[q] *= da;
      }
    }
    // inclusive scan of the folds over the warp's slices of this channel
    for (int o = gc; o < 32; o <<= 1) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float Pp = __shfl_up_sync(0xffffffffu, P[q], o);
        const float Sp = __shfl_up_sync(0xffffffffu, S[q], o);
        if (k.lane >= o) {
          S[q] = fmaf(P[q], Sp, S[q]);
          P[q] *= Pp;
        }
      }
    }
    float* wg = k.wagg + (step & 1) * kWarps * gc * 2 * kCols;
    float h[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (sl == last_sl) {
        wg[((k.warp * gc + ch) * 2) * kCols + q] = P[q];
        wg[((k.warp * gc + ch) * 2 + 1) * kCols + q] = S[q];
      }
      const float Pe = __shfl_up_sync(0xffffffffu, P[q], gc);
      const float Se = __shfl_up_sync(0xffffffffu, S[q], gc);
      P[q] = sl == 0 ? 1.f : Pe;
      S[q] = sl == 0 ? 0.f : Se;
    }
    __syncthreads();
    // the state entering this thread's tokens: the carry through the
    // earlier warps' folds, then the earlier slices of this warp
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      h[q] = n0 + q < N ? carry_in[ch * cs + n0 + q] : 0.f;
    for (int w = 0; w < k.warp; ++w) {
      const float* g = wg + (w * gc + ch) * 2 * kCols;
#pragma unroll
      for (int q = 0; q < kCols; ++q) h[q] = fmaf(g[q], h[q], g[kCols + q]);
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) h[q] = fmaf(P[q], h[q], S[q]);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (jt[i] < 0) continue;
      const bool pad = dtv[i] == 0.f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (!pad) h[q] = fmaf(av[i][q], h[q], bv[i][q]);
        if (n0 + q < N)
          yv[i] = fmaf(h[q], k.cs_[(i * slices + s) * k.rb + n0 + q],
                       yv[i]);
      }
    }
    if (s == slices - 1) {
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (n0 + q < N) carry_out[ch * cs + n0 + q] = h[q];
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (jt[i] >= 0) y[static_cast<size_t>(toks[jt[i]]) * k.D + d] = yv[i];
  __syncthreads();  // the carry is out; the staging buffers are free
}

// ---- the kernel -----------------------------------------------------------

// Grid (R + 1) x groups: block (row, g) takes `row`'s tokens at channels
// [g gc, g gc + gc), gathering them a pass at a time (any T fits); block row
// R takes the tokens outside [0, R).
template <int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ b, const float* __restrict__ c,
                    const float* __restrict__ a, const float* __restrict__ h0,
                    const int* __restrict__ seq, float* __restrict__ y,
                    float* __restrict__ h_out, int T, int D, int N, int R,
                    int gc, bool vec) {
  extern __shared__ __align__(16) int smem[];
  Block k;
  k.T = T;
  k.D = D;
  k.N = N;
  k.R = R;
  k.gc = gc;
  k.cs = N | 1;
  k.rb = stride_bc(N);
  k.rg = stride_dx(gc);
  k.vec = vec;
  k.lane = threadIdx.x % 32;
  k.warp = threadIdx.x / 32;
  const int tid = threadIdx.x;
  const int slices = kThreads / gc, chunk = slices * L;
  const int groups = (D + gc - 1) / gc;
  k.d0 = static_cast<int>(blockIdx.x % groups) * gc;
  k.row = static_cast<int>(blockIdx.x / groups);
  k.bs = reinterpret_cast<float*>(smem);
  k.cs_ = k.bs + chunk * k.rb;
  k.dts = k.cs_ + chunk * k.rb;
  k.xs = k.dts + chunk * k.rg;
  k.list = reinterpret_cast<int*>(k.xs + chunk * k.rg);
  k.wsum = k.list + chunk + kThreads * kWindow;
  k.as = reinterpret_cast<float*>(k.wsum + kWarps);
  k.carry = k.as + gc * k.cs;
  k.wagg = k.carry + 2 * gc * k.cs;
  k.wb = k.wagg + 2 * kWarps * gc * 2 * kCols;
  k.wc = k.wb + kBatch * k.cs;
  k.wdt = k.wc + kBatch * k.cs;
  k.wx = k.wdt + kBatch * (gc + 1);
  k.wh = k.wx + kBatch * (gc + 1);
  // A of the block's channels, staged while the row is gathered
  for (int i = tid; i < gc * N; i += kThreads)
    if (k.d0 + i / N < D)
      copy4(k.as + (i / N) * k.cs + i % N,
            a + static_cast<size_t>(k.d0) * N + i);
  __pipeline_commit();
  k.pos = k.have = 0;
  // (row R's tokens go kBatch at a time: drop keeps at most one pass)
  fill(k, seq, k.row == R ? kBatch : chunk);
  if (k.row == R || (k.pos >= k.T && k.have <= kBatch)) {
    // tokens outside [0, R) each from a zero state, or a short row
    int m = min(k.have, kBatch);
    walk_short(k, x, dt, b, c, a, h0, y, h_out, k.list, m, k.row);
    while (k.row == R && (k.have > m || k.pos < k.T)) {
      drop(k, m);
      fill(k, seq, kBatch);
      m = min(k.have, kBatch);
      walk_short(k, x, dt, b, c, a, h0, y, h_out, k.list, m, R);
    }
    return;
  }
  const int ch = tid % gc, s = tid / gc;
  const int gcs = gc * k.cs;
  // a row gathered whole ends in pads: list[real, real + pads)
  const int real = k.pos >= k.T ? trailing_pads(k, dt) : k.have;
  const int pads = k.have - real;
  k.have = real;
  int step = 0, buf = 0;
  const bool scan = real > kBatch;
  if (scan)
    stage_chunk(k, x, dt, b, c, h0, k.list, min(k.have, chunk), slices,
                k.row);
  else  // what the pads leave is walked with no scan
    walk_short(k, x, dt, b, c, a, h0, y, h_out, k.list, real, k.row,
               k.carry);
  while (scan && k.have > 0) {
    const int m = min(k.have, chunk);
    scan_chunk<L>(k, y, k.list, m, ch, s, slices, k.carry + buf * gcs,
                  k.carry + (buf ^ 1) * gcs, step);
    buf ^= 1;
    // the next chunk's copies go out before the list is compacted when
    // its tokens are gathered already, else once the gather has them
    const bool ready = k.have - m >= chunk || k.pos >= k.T;
    if (ready && k.have > m)
      stage_chunk(k, x, dt, b, c, nullptr, k.list + m,
                  min(k.have - m, chunk), slices, -1);
    drop(k, m);
    fill(k, seq, chunk);
    if (!ready && k.have > 0)
      stage_chunk(k, x, dt, b, c, nullptr, k.list, min(k.have, chunk),
                  slices, -1);
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the final state is in carry buffer buf
  // the pads' y from the final state (drop left them in place), chunk
  // tokens at a time: their C rows staged, then a thread a (pad, channel)
  const float* hf = k.carry + buf * gcs;
  const int lg = __ffs(gc) - 1;
  const int w = k.vec ? 4 : 1, every = kThreads / (N / w);
  const int r = tid % (N / w);
  for (int p0 = 0; p0 < pads; p0 += chunk) {
    const int m = min(chunk, pads - p0);
    const int* toks = k.list + real + p0;
    if (tid < every * (N / w))
      for (int j = tid / (N / w); j < m; j += every) {
        float* d = k.cs_ + j * k.rb + r * w;
        const float* src = c + static_cast<size_t>(toks[j]) * N + r * w;
        if (k.vec)
          copy16(d, src);
        else
          copy4(d, src);
      }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int i = tid; i < m * gc; i += kThreads) {
      const int cc = i & (gc - 1), j = i >> lg;
      if (k.d0 + cc >= D) continue;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxState; ++q)
        if (q < N) v = fmaf(hf[cc * k.cs + q], k.cs_[j * k.rb + q], v);
      y[static_cast<size_t>(toks[j]) * D + k.d0 + cc] = v;
    }
    __syncthreads();  // the C rows are read
  }
  const size_t at = k.row * (static_cast<size_t>(D) * N) +
                    static_cast<size_t>(k.d0) * N;
  for (int i = tid; i < gc * N; i += kThreads)
    if (k.d0 + i / N < D)
      h_out[at + i] = k.carry[buf * gcs + (i / N) * k.cs + i % N];
}

// A stream of at most kBatch tokens (the decode step): grid ceil(R /
// kMaxGroup) x groups; block (q, g), gc x lanes threads (whole warps),
// takes rows [G q, G q + G), G = kMaxGroup, at channels [g gc, g gc + gc);
// block row 0 also takes the tokens outside [0, R). The tokens' rows, dt
// and x at the block's channels and their B and C rows are copied into
// shared memory by cp.async, all at once, while each thread (channel,
// column) loads its G states into registers; then each thread applies
// the tokens of its rows in order and leaves h C in shared memory, and
// after one barrier a thread per (token, channel) sums them over the
// columns in order.
__global__ void __launch_bounds__(kThreads)
    ssm_decode_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ a,
                      const float* __restrict__ h0,
                      const int* __restrict__ seq, float* __restrict__ y,
                      float* __restrict__ h_out, int T, int D, int N, int R,
                      int gc) {
  // inputs of the stream (kBatch tokens at most), and each (token,
  // channel)'s products over the columns, padded by one float
  __shared__ float xs[kBatch * 32], dts[kBatch * 32];
  __shared__ float bs[kBatch * kMaxState], cs[kBatch * kMaxState];
  __shared__ float ps[kBatch * (kThreads + 32)];
  __shared__ int ss[kBatch];
  const int groups = (D + gc - 1) / gc;
  const int q = static_cast<int>(blockIdx.x / groups);
  const int d0 = static_cast<int>(blockIdx.x % groups) * gc;
  const int lanes = lanes_of(N), p = threadIdx.x;
  const int ch = p / lanes, col = p % lanes, d = d0 + ch;
  const bool live = p < gc * lanes && col < N && d < D;
  const int nn = col < N ? col : 0;  // pad lanes' products are not summed
  const int nch = min(gc, D - d0);
  for (int i = p; i < T * nch; i += blockDim.x) {
    const size_t g = static_cast<size_t>(i / nch) * D + d0 + i % nch;
    copy4(xs + (i / nch) * gc + i % nch, x + g);
    copy4(dts + (i / nch) * gc + i % nch, dt + g);
  }
  for (int i = p; i < T * N; i += blockDim.x) {
    copy4(bs + i, b + i);
    copy4(cs + i, c + i);
  }
  if (p < T) copy4(ss + p, seq + p);
  __pipeline_commit();
  const int r0 = q * kMaxGroup, nr = min(kMaxGroup, R - r0);
  const size_t DN = static_cast<size_t>(D) * N;
  const size_t dn = static_cast<size_t>(d) * N + col;
  float hr[kMaxGroup];
#pragma unroll
  for (int u = 0; u < kMaxGroup; ++u)
    hr[u] = live && u < nr ? h0[(r0 + u) * DN + dn] : 0.f;
  const float an = live ? exp_factor(__ldg(a + dn)) : 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();
  const int pw = lanes + 1;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (j >= T) break;
    const int u = ss[j] - r0;  // the same in every thread
    const bool inside = ss[j] >= 0 && ss[j] < R;
    const bool mine = inside && u >= 0 && u < nr;
    if (!(mine || (!inside && q == 0))) continue;
    float h = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxGroup; ++w)
      if (mine && w == u) h = hr[w];
    const int jc = j * gc + (live ? ch : 0);
    const float dtv = dts[jc];
    const float hn = fmaf(exp_dt(dtv, an), h, (dtv * xs[jc]) * bs[j * N + nn]);
#pragma unroll
    for (int w = 0; w < kMaxGroup; ++w)
      if (mine && w == u) hr[w] = hn;
    if (p < gc * lanes) ps[(j * gc + ch) * pw + col] = hn * cs[j * N + nn];
  }
  __syncthreads();  // the products are in place
  for (int i = p; i < T * nch; i += blockDim.x) {
    const int j = i / nch, cc = i % nch, u = ss[j] - r0;
    const bool inside = ss[j] >= 0 && ss[j] < R;
    if (inside ? (u < 0 || u >= nr) : q != 0) continue;
    const float* pp = ps + (j * gc + cc) * pw;
    float v = 0.f;
    for (int m = 0; m < N; ++m) v += pp[m];
    y[static_cast<size_t>(j) * D + d0 + cc] = v;
  }
#pragma unroll
  for (int u = 0; u < kMaxGroup; ++u)
    if (live && u < nr) h_out[(r0 + u) * DN + dn] = hr[u];
}

template <int L>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* h0, const int* seq, float* y,
           float* h_out, int T, int D, int N, int R, int gc, cudaStream_t s) {
  if (gc < 1 || gc > 32 || (gc & (gc - 1)) || N < 1 || N > kMaxState ||
      gc * lanes_of(N) > kThreads)
    return cudaErrorInvalidValue;
  const long long groups = (D + gc - 1) / gc;
  if (T <= kBatch) {  // the decode step
    const long long blocks = (R + kMaxGroup - 1LL) / kMaxGroup * groups;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    // whole warps: the shuffles need every lane
    const int pairs = (gc * lanes_of(N) + 31) / 32 * 32;
    ssm_decode_kernel<<<static_cast<int>(blocks), pairs, 0, s>>>(
        x, dt, b, c, a, h0, seq, y, h_out, T, D, N, R, gc);
    return cudaGetLastError();
  }
  const long long blocks = (R + 1LL) * groups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t bytes = smem_words(gc, L, N) * 4;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  // 16-byte copies: whole pieces of B, C rows and of a block's channels
  const size_t bits = reinterpret_cast<size_t>(x) |
                      reinterpret_cast<size_t>(dt) |
                      reinterpret_cast<size_t>(b) | reinterpret_cast<size_t>(c);
  const bool vec =
      N % 4 == 0 && gc % 4 == 0 && D % 4 == 0 && (bits & 15) == 0;
  ssm_scan_kernel<L><<<static_cast<int>(blocks), kThreads, bytes, s>>>(
      x, dt, b, c, a, h0, seq, y, h_out, T, D, N, R, gc, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All float32 and contiguous: x, dt, y [T, D]; b, c [T, N]; a [D, N];
// h0, h_out [R, D, N]; token_seq int32 [T]. N <= 32. gc channels a block
// (a power of two <= 32, gc x N rounded up to a power of two <= 128);
// `tokens` (1, 4, 8) a thread of a scanned chunk. A stream of at most 8
// tokens runs the decode kernel (gc x lanes threads).
int ssm_scan(const float* x, const float* dt, const float* b, const float* c,
             const float* a, const float* h0, const int* token_seq, float* y,
             float* h_out, int T, int D, int N, int R, int gc, int tokens,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSM_LAUNCH(L_)                                                     \
  return launch<L_>(x, dt, b, c, a, h0, token_seq, y, h_out, T, D, N, R, \
                    gc, s)
  switch (tokens) {
    case 1: SSM_LAUNCH(1);
    case 4: SSM_LAUNCH(4);
    case 8: SSM_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef SSM_LAUNCH
}

}  // extern "C"
