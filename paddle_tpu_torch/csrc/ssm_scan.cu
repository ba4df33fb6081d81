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
// the tokens are applied in stream order. Pads carry dt = 0, an identity
// update (exp(0) = 1, the input term 0). A token whose row lies outside
// [0, R) reads a zero state and writes none, as the reference's one-hot
// row select does.
//
// What bounds it on the card. Bytes: x, dt and y ([T, D]), h0 and h_out
// ([R, D, N]), A, B, C and token_seq once each: at serving shapes
// (D 1536, N 16, R 8) about 1.8 MB at T = 8 (0.54 us at 3.35 TB/s) and
// 6.4 MB at T = 256 (1.9 us). Operations: about 7 float32 operations per
// state element per token, below the byte bound. But the scan is a chain:
// each state element takes T dependent updates in order, so the least
// time of this design is T times the latency of one update, far above the
// byte bound at T = 256.
//
// What the design does about it:
//   - one thread per (channel d, state column n) lane; N is rounded up to
//     a power of two (the template's kLanes), so the lanes of a channel
//     sit in one warp; a block takes `db` channels (choose_d_block in
//     ops/kernels/ssm_scan.py), at most 128 threads;
//   - the R rows' states live in shared memory laid out [row][thread]:
//     each thread reads and writes only its own lane of every row, so a
//     token's row is a dynamic index with no divergence and no barrier;
//   - token tiles (x and dt of the block's channels, B, C, token_seq) of
//     kChunk tokens are staged into shared memory by cp.async, double
//     buffered: chunk k + 1 is in flight while chunk k is scanned, so the
//     loop never waits on device memory;
//   - inside the loop a token's chain is one shared-memory load of h_r,
//     one fused multiply-add and a store; exp(dt * A) and the input term
//     do not depend on h and leave the chain. The products h * C are
//     parked in shared memory and y's sums over N are taken after each
//     chunk, one thread per (token, channel), off the chain.
// expf, not __expf: the twin's tolerance (1e-5) needs the accurate one.
// nvcc contracts a*b + c into FMAs, so y and h differ from the plain twin
// (ops/kernels/ssm_scan.py) by a few float32 ulps; a row that only pads
// touch keeps its state bit for bit.
// Not done yet (later work): a step walks all T tokens in one chain even
// when its rows are independent; a per-row split of the loop, or a
// chunked (SSD-style) scan, would shorten it.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes. It launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kChunk = 32;                 // tokens staged at a time
constexpr int kMaxThreads = 128;           // threads of a block
constexpr size_t kMaxSmem = 232448;        // a Hopper block's shared memory
constexpr size_t kDefaultSmem = 48 * 1024;  // without the opt-in attribute

// floats of a block's shared memory: the row states, two staged chunks
// (x and dt tiles, B and C tiles, token rows) and one chunk's products
size_t smem_floats(int R, int db, int lanes, int N) {
  const size_t threads = static_cast<size_t>(db) * lanes;
  return static_cast<size_t>(R) * threads + 2 * 2 * kChunk * size_t(db) +
         2 * 2 * kChunk * size_t(N) + 2 * kChunk +
         kChunk * size_t(db) * (lanes + 1);
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

// Issue the copies of chunk k into buffer buf and commit them as one group;
// elements past T or D are zeroed instead.
__device__ __forceinline__ void stage(int k, int buf, const float* x,
                                      const float* dt, const float* b,
                                      const float* c, const int* seq, int T,
                                      int D, int N, int d0, int db, float* xs,
                                      float* dts, float* bs, float* cs,
                                      int* ss) {
  const int t0 = k * kChunk;
  float* xb = xs + buf * kChunk * db;
  float* dtb = dts + buf * kChunk * db;
  float* bb = bs + buf * kChunk * N;
  float* cb = cs + buf * kChunk * N;
  int* sb = ss + buf * kChunk;
  for (int i = threadIdx.x; i < kChunk * db; i += blockDim.x) {
    const int t = t0 + i / db, d = d0 + i % db;
    if (t < T && d < D) {
      const size_t g = static_cast<size_t>(t) * D + d;
      copy4(xb + i, x + g);
      copy4(dtb + i, dt + g);
    } else {
      xb[i] = 0.f;
      dtb[i] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < kChunk * N; i += blockDim.x) {
    if (t0 + i / N < T) {
      const size_t g = static_cast<size_t>(t0) * N + i;
      copy4(bb + i, b + g);
      copy4(cb + i, c + g);
    } else {
      bb[i] = 0.f;
      cb[i] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    if (t0 + i < T)
      copy4(sb + i, seq + t0 + i);
    else
      sb[i] = 0;
  }
  __pipeline_commit();
}

// Grid: one block per db channels. Thread tid owns lane (dl, n) =
// (tid / kLanes, tid % kLanes) of channel d0 + dl.
template <int kLanes>
__global__ void __launch_bounds__(kMaxThreads)
    ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ b, const float* __restrict__ c,
                    const float* __restrict__ a, const float* __restrict__ h0,
                    const int* __restrict__ seq, float* __restrict__ y,
                    float* __restrict__ h_out, int T, int D, int N, int R,
                    int db) {
  extern __shared__ float smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int dl = tid / kLanes, n = tid % kLanes;
  const int d0 = blockIdx.x * db, d = d0 + dl;
  const bool live = n < N && d < D;
  // lanes past N compute on column 0; their products are never summed
  const int nn = n < N ? n : 0;
  float* hs = smem;
  float* xs = hs + static_cast<size_t>(R) * threads;
  float* dts = xs + 2 * kChunk * db;
  float* bs = dts + 2 * kChunk * db;
  float* cs = bs + 2 * kChunk * N;
  float* ps = cs + 2 * kChunk * N;
  int* ss = reinterpret_cast<int*>(ps + kChunk * db * (kLanes + 1));
  // a token's products, padded by one float a channel: the sums below
  // read 32 different banks
  const int pw = db * (kLanes + 1);
  const int pl = dl * (kLanes + 1) + n;
  const size_t DN = static_cast<size_t>(D) * N;
  const size_t lane = static_cast<size_t>(d) * N + n;

  stage(0, 0, x, dt, b, c, seq, T, D, N, d0, db, xs, dts, bs, cs, ss);
  for (int r = 0; r < R; ++r)
    hs[static_cast<size_t>(r) * threads + tid] = live ? h0[r * DN + lane] : 0.f;
  const float a_dn = live ? a[lane] : 0.f;

  const int n_chunks = (T + kChunk - 1) / kChunk;
  for (int k = 0; k < n_chunks; ++k) {
    const int buf = k & 1;
    __pipeline_wait_prior(0);
    __syncthreads();  // chunk k landed; the last chunk's sums are read
    if (k + 1 < n_chunks)
      stage(k + 1, buf ^ 1, x, dt, b, c, seq, T, D, N, d0, db, xs, dts, bs,
            cs, ss);
    const int t0 = k * kChunk;
    const int nt = min(kChunk, T - t0);
    const float* xk = xs + buf * kChunk * db;
    const float* dtk = dts + buf * kChunk * db;
    const float* bk = bs + buf * kChunk * N;
    const float* ck = cs + buf * kChunk * N;
    const int* sk = ss + buf * kChunk;
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const int row = sk[j];
      const bool inside = row >= 0 && row < R;  // the same in every thread
      const float dtv = dtk[j * db + dl];
      const float da = expf(dtv * a_dn);
      const float dbx = (dtv * xk[j * db + dl]) * bk[j * N + nn];
      float* hp = hs + static_cast<size_t>(inside ? row : 0) * threads + tid;
      const float h = da * (inside ? *hp : 0.f) + dbx;
      if (inside) *hp = h;
      ps[j * pw + pl] = h * ck[j * N + nn];
    }
    __syncthreads();  // the chunk's products are in place
    for (int i = tid; i < nt * db; i += threads) {
      const int j = i / db, ch = i % db;
      if (d0 + ch < D) {
        const float* p = ps + j * pw + ch * (kLanes + 1);
        float s = 0.f;
        for (int m = 0; m < N; ++m) s += p[m];
        y[static_cast<size_t>(t0 + j) * D + d0 + ch] = s;
      }
    }
  }
  if (live)
    for (int r = 0; r < R; ++r)
      h_out[r * DN + lane] = hs[static_cast<size_t>(r) * threads + tid];
}

int lanes_of(int N) {
  int l = 1;
  while (l < N) l <<= 1;
  return l;
}

template <int kLanes>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* h0, const int* seq, float* y,
           float* h_out, int T, int D, int N, int R, int db, cudaStream_t s) {
  const int threads = db * kLanes;
  if (db < 1 || threads > kMaxThreads) return cudaErrorInvalidValue;
  const size_t bytes = smem_floats(R, db, kLanes, N) * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const int grid = (D + db - 1) / db;
  ssm_scan_kernel<kLanes><<<grid, threads, bytes, s>>>(
      x, dt, b, c, a, h0, seq, y, h_out, T, D, N, R, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the most state rows a block of db channels holds at d_state N
int ssm_scan_max_rows(int db, int N) {
  const int lanes = lanes_of(N);
  const size_t fixed = smem_floats(0, db, lanes, N) * sizeof(float);
  const size_t row = static_cast<size_t>(db) * lanes * sizeof(float);
  return fixed >= kMaxSmem ? 0 : static_cast<int>((kMaxSmem - fixed) / row);
}

// All float32 and contiguous: x, dt, y [T, D]; b, c [T, N]; a [D, N];
// h0, h_out [R, D, N]; token_seq int32 [T]. N <= 32; db channels a block.
int ssm_scan(const float* x, const float* dt, const float* b, const float* c,
             const float* a, const float* h0, const int* token_seq, float* y,
             float* h_out, int T, int D, int N, int R, int db, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes_of(N)) {
    case 1:
      return launch<1>(x, dt, b, c, a, h0, token_seq, y, h_out, T, D, N, R,
                       db, s);
    case 2:
      return launch<2>(x, dt, b, c, a, h0, token_seq, y, h_out, T, D, N, R,
                       db, s);
    case 4:
      return launch<4>(x, dt, b, c, a, h0, token_seq, y, h_out, T, D, N, R,
                       db, s);
    case 8:
      return launch<8>(x, dt, b, c, a, h0, token_seq, y, h_out, T, D, N, R,
                       db, s);
    case 16:
      return launch<16>(x, dt, b, c, a, h0, token_seq, y, h_out, T, D, N, R,
                        db, s);
    case 32:
      return launch<32>(x, dt, b, c, a, h0, token_seq, y, h_out, T, D, N, R,
                        db, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
