// Ragged paged attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_kernel` (launched by the pallas_call in `ragged_paged_attention`).
// One call attends a batch of query tokens that mixes decode tokens and
// prefill-chunk tokens of different sequences. For every token t with
// page-table row r = token_seq[t]:
//
//   out[t, h] = softmax_{j < bounds[t]}(q[t, h] . K_r[j, h / fold] * scale)
//               . V_r[j, h / fold]
//
// K_r / V_r are read through page_table[r] from the pools
// [n_pages, P, H_kv, D]; fold = H / H_kv (grouped-query attention). The
// softmax is online in float32 with the finite mask value -1e30 and
// probabilities outside the bound zeroed explicitly. A pad token (bound 0)
// does no work and its output is exactly 0. work[t] is the number of kv
// pages t's softmax covers: ceil(bounds[t] / P) capped at the table width
// W, 0 for a pad.
//
// What bounds it on the card: reading K/V pages. A serving step's tokens
// attend over their histories at about 4 flops per byte of K/V (bf16),
// far below the H100's ~295 flops/byte ridge, so the least time is the
// K/V bytes the step needs over 3.35 TB/s. The work is ragged: a mixed
// step holds a prefill chunk of up to 128 tokens of one sequence and a
// few decode tokens with histories of hundreds of tokens each.
//
// The design. The host builds a schedule (ops/kernels/paged_attention.py
// `ragged_schedule`) of work units; every unit holds tokens of ONE
// page-table row and runs once for each kv head (grid y):
// - a prefill run of a row is cut into units of up to 64 q rows (tokens
//   x the fold query heads of the kv head); in bfloat16 they run on the
//   tensor cores (tc_block): Q resident in a 128-byte-swizzled
//   tile, K and V gathered 64 keys (4 pages of 16) at a time through the
//   page table by cp.async into swizzled stages, S = Q.K^T and O += P.V
//   by wgmma.m64n64k16 with the online softmax on S's accumulator in
//   registers and P fed back as the A operand (the structure of
//   flash_attention.cu's flash_fwd_tc_kernel). Key tiles past the unit's
//   largest bound are skipped; only tiles that cross a row's bound are
//   masked;
// - a decode token (fold q rows) is its own unit and runs on the CUDA
//   cores (cc_block), as every unit does in float32. Its page
//   range may be split across blocks (split-KV) so that a step of a few
//   long histories still fills the 132 SMs. Each warp of a block walks
//   its own pages through a cp.async ring of three stages (two pages in
//   flight while it computes one); groups of 8-32 lanes share one key,
//   each lane a 16-byte slice of it, so every lane is busy on a 16-key
//   page, and the score is reduced by a few shuffles. Each lane reads
//   back only the slices it copied itself: no barrier in the walk;
// - a split unit writes float32 partials (m, l, o[D]) to a scratch
//   buffer and counts itself done on a per-(unit, kv head) ticket (an
//   integer atomic); the split that finishes last combines all the
//   partials in split order and resets the ticket, so the result does not
//   depend on which split finished first (no float atomics);
// - pad tokens get no unit: extra blocks after the CUDA-core units zero
//   their rows.
// The schedule's table starts with a header of the live counts (tc rows,
// cc rows, pads, split slots), which every block reads: the launch is
// sized by the table's layout (the counts passed in), and a block past a
// live count returns at once. For an eager call the layout is the live
// counts; a CUDA graph captures a table padded to the capacity of its
// (tokens, rows, table width) signature, so that one launch configuration
// serves every plan of the signature (ops/kernels/paged_attention.py
// `ragged_capacity`).
// In bfloat16 one launch (paged_cc_tc_kernel) runs the tensor-core units
// and then the CUDA-core units and pads, so that a mixed step's prefill
// and decode work share the SMs; CUDA-core units of 16 q rows (a GQA fold
// above 4) take a second launch (paged_cc_kernel), as every float32 call
// takes that one alone. So a call makes 1 or 2 launches.
//
// Built by nvcc into a shared library with a plain C interface
// (ops/kernels/_build.py) and called through ctypes
// (ops/kernels/paged_attention.py). It launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kUnitInts = 8;    // ints of a schedule row
constexpr int kKeys = 16;       // keys of a chunk; P is a multiple of it
constexpr int kTcRows = 64;     // q rows of a tensor-core unit
constexpr int kTcKeys = 64;     // keys of a tensor-core tile
constexpr int kTcStagesK = 2;   // only S reads a K tile
constexpr int kTcStagesV = 3;   // the late O product still reads one
constexpr int kCcRows = 16;     // q rows of a CUDA-core unit (max fold)
constexpr int kCcWarps = 4;
constexpr int kCcThreads = kCcWarps * 32;
constexpr int kRing = 3;        // chunk stages of a warp's ring
constexpr int kPadTokens = 32;  // pad tokens one block zeroes
constexpr int kHeaderInts = 4;  // the table's header: the live counts
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* page_table;
  const int* bounds;
  const int* sched;  // header | tc rows | cc rows | pad token ids
  void* out;
  int* work;
  float* part_ml;  // [parts][H_kv][rm][2] (m, l) of split units
  float* part_o;   // [parts][H_kv][rm][D]
  int* tickets;    // [parts][H_kv] splits done; 0 between calls
  int n_heads, n_kv, fold, n_pages, P, W;
  int n_tc, n_cc, n_pad, rm;  // the table's layout (rows, ids)
  float scale2;  // scale * log2(e): scores in log2 units
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the 16 bytes at p as floats: 8 bf16 or 4 float32
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// pages token t's softmax covers: ceil(bound / P) capped at W
__device__ __forceinline__ int work_of(int b, const Args& a) {
  return b > 0 ? min((b + a.P - 1) / a.P, a.W) : 0;
}

// output row of q row m of a unit starting at token t0, kv head g
__device__ __forceinline__ size_t out_row(const Args& a, int t0, int m,
                                          int g) {
  const int tk = m / a.fold;
  return (size_t)(t0 + tk) * a.n_heads + g * a.fold + (m - tk * a.fold);
}

// ---- CUDA cores: decode units (and every unit in float32) -------------------
//
// Lane geometry of a 16-byte slice: kVe elements, kL lanes per key, kG keys
// a warp reads at once, kKi keys of a chunk per lane. Lane l holds slice
// l % kL of keys l / kL + kG * i.
template <typename T, int D>
struct Cc {
  static constexpr int kVe = 16 / (int)sizeof(T);
  static constexpr int kL = D / kVe;
  static constexpr int kG = 32 / kL;
  static constexpr int kKi = kKeys / kG;
  static constexpr int kStage = 2 * kKeys * D;  // elements: K then V
};

// the rows of the schedule, past its header
__device__ __forceinline__ const int* units(const Args& a) {
  return a.sched + kHeaderInts;
}

// CUDA-core block b: cc row b, or past the rows, a block of pad tokens;
// a block past the live rows or pads returns at once. Every product that
// meets a sum is an explicit fmaf or __fmul_rn, so that no build of RM
// contracts another: a unit's bits do not depend on the RM it runs under
// (a captured step's capacity table may take a larger RM than the exact
// table of the same plan).
// A unit's q rows (at most RM, the template bound) walk keys [k_lo, k_hi)
// of one row; the block's 4 warps take chunks of 16 keys in turn. A split
// writes partials and counts itself done on the unit's ticket; the split
// that finishes last merges them all, in split order, and resets it.
template <typename T, int D, int RM>
__device__ __forceinline__ void cc_block(const Args& a, int b) {
  using C = Cc<T, D>;
  extern __shared__ __align__(16) unsigned char smem_cc[];
  float* q_s = reinterpret_cast<float*>(smem_cc);  // [RM][D]
  T* ring = reinterpret_cast<T*>(q_s + RM * D);    // [warps][kRing][stage]
  const int g = blockIdx.y;
  T* out = static_cast<T*>(a.out);

  if (b >= a.n_cc) {  // pad tokens: zero rows, no work
    const int* pads = units(a) + (a.n_tc + a.n_cc) * kUnitInts;
    const int p0 = (b - a.n_cc) * kPadTokens;
    const int np = min(kPadTokens, a.sched[2] - p0);
    if (np <= 0) return;
    constexpr int kVecs = D * (int)sizeof(T) / 16;  // per head row
    const int per_tok = a.fold * kVecs;
    for (int i = threadIdx.x; i < np * per_tok; i += kCcThreads) {
      const int j = i / per_tok, x = i - j * per_tok;
      const size_t row = (size_t)pads[p0 + j] * a.n_heads + g * a.fold;
      reinterpret_cast<uint4*>(out + row * D)[x] = make_uint4(0, 0, 0, 0);
    }
    if (g == 0 && (int)threadIdx.x < np) a.work[pads[p0 + threadIdx.x]] = 0;
    return;
  }

  if (b >= a.sched[1]) return;
  const int* u = units(a) + (a.n_tc + b) * kUnitInts;
  const int t0 = u[0], n_tok = u[1], row = u[2], k_lo = u[3], k_hi = u[4],
            part = u[5], part0 = u[6], n_split = u[7];
  const int R = n_tok * a.fold;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sl = lane % C::kL, grp = lane / C::kL;
  const int c_lo = k_lo / kKeys;
  const int n_chunks = (k_hi + kKeys - 1) / kKeys - c_lo;
  const int n_mine =
      n_chunks > warp ? (n_chunks - warp + kCcWarps - 1) / kCcWarps : 0;
  T* my_ring = ring + warp * kRing * C::kStage;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  // chunk i of this warp into stage i % kRing; an empty group past the
  // end keeps the wait counts uniform. Keys past k_hi read as zeros.
  auto issue = [&](int i) {
    if (i < n_mine) {
      const int key0 = (c_lo + warp + kCcWarps * i) * kKeys;
      const int page = a.page_table[(size_t)row * a.W + key0 / a.P];
      const bool in_pool = page >= 0 && page < a.n_pages;
      const size_t base = ((size_t)page * a.P + key0 % a.P) * a.n_kv + g;
      T* st = my_ring + (i % kRing) * C::kStage;
#pragma unroll
      for (int kk = 0; kk < C::kKi; ++kk) {
        const int key = grp + C::kG * kk;
        const bool ok = in_pool && key0 + key < k_hi;
        const size_t at = ok ? (base + (size_t)key * a.n_kv) * D + sl * C::kVe
                             : 0;
        cp_async16(smem_u32(st + key * D + sl * C::kVe), kp + at, ok);
        cp_async16(smem_u32(st + (kKeys + key) * D + sl * C::kVe), vp + at,
                   ok);
      }
    }
    cp_async_commit();
  };

  // the first two chunks are in flight while the q rows load
  issue(0);
  issue(1);
  const T* q = static_cast<const T*>(a.q);
  for (int i = threadIdx.x; i < R * D; i += kCcThreads) {
    const int m = i / D;
    q_s[i] = to_f32(q[out_row(a, t0, m, g) * D + (i - m * D)]) * a.scale2;
  }
  // each row's last key + 1: its bound, the table's end, the split's end
  int lim[RM];
#pragma unroll
  for (int m = 0; m < RM; ++m)
    lim[m] = m < R ? min(min(a.bounds[t0 + m / a.fold], a.W * a.P), k_hi)
                   : 0;
  __syncthreads();

  // per row, this lane group's online softmax over its keys: running max
  // m (log2 units), sum l and this lane's slice of the output
  float m_r[RM], l_r[RM], o[RM][C::kVe];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    m_r[m] = kNegInf;
    l_r[m] = 0.f;
#pragma unroll
    for (int e = 0; e < C::kVe; ++e) o[m][e] = 0.f;
  }
  for (int i = 0; i < n_mine; ++i) {
    issue(i + 2);
    cp_async_wait<2>();  // chunk i is in (this lane's own copies)
    const T* st = my_ring + (i % kRing) * C::kStage;
    const int key0 = (c_lo + warp + kCcWarps * i) * kKeys;
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      if (m >= R) break;
      float qv[C::kVe];
#pragma unroll
      for (int e = 0; e < C::kVe; e += 4) {
        const float4 f =
            *reinterpret_cast<const float4*>(q_s + m * D + sl * C::kVe + e);
        qv[e] = f.x, qv[e + 1] = f.y, qv[e + 2] = f.z, qv[e + 3] = f.w;
      }
      float s[C::kKi], mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < C::kKi; ++kk) {
        const int key = grp + C::kG * kk;
        float kx[C::kVe];
        unpack16(st + key * D + sl * C::kVe, kx);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < C::kVe; ++e) acc = fmaf(qv[e], kx[e], acc);
#pragma unroll
        for (int off = 1; off < C::kL; off <<= 1)
          acc += __shfl_xor_sync(kFull, acc, off);
        s[kk] = key0 + key < lim[m] ? acc : kNegInf;
        mx = fmaxf(mx, s[kk]);
      }
      const float m_new = fmaxf(m_r[m], mx);
      const float alpha = ex2(m_r[m] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < C::kVe; ++e) o[m][e] *= alpha;
#pragma unroll
      for (int kk = 0; kk < C::kKi; ++kk) {
        const int key = grp + C::kG * kk;
        const float p = key0 + key < lim[m] ? ex2(s[kk] - m_new) : 0.f;
        psum += p;
        float vx[C::kVe];
        unpack16(st + (kKeys + key) * D + sl * C::kVe, vx);
#pragma unroll
        for (int e = 0; e < C::kVe; ++e) o[m][e] = fmaf(p, vx[e], o[m][e]);
      }
      l_r[m] = fmaf(l_r[m], alpha, psum);
      m_r[m] = m_new;
    }
  }
  cp_async_wait<0>();

  // merge the warp's lane groups (xor butterflies, the same order in
  // every run), then the block's warps through shared memory in order
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    if (m >= R) break;
#pragma unroll
    for (int off = C::kL; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(kFull, m_r[m], off);
      const float lo = __shfl_xor_sync(kFull, l_r[m], off);
      const float mm = fmaxf(m_r[m], mo);
      const float a1 = ex2(m_r[m] - mm), a2 = ex2(mo - mm);
      l_r[m] = fmaf(l_r[m], a1, __fmul_rn(lo, a2));
#pragma unroll
      for (int e = 0; e < C::kVe; ++e)
        o[m][e] = fmaf(o[m][e], a1,
                       __fmul_rn(__shfl_xor_sync(kFull, o[m][e], off), a2));
      m_r[m] = mm;
    }
  }
  __syncthreads();  // every warp is done with its ring
  float* ml_s = reinterpret_cast<float*>(ring);  // [warps][RM][2]
  float* o_s = ml_s + kCcWarps * RM * 2;         // [warps][RM][D]
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    if (m >= R) break;
    if (lane == 0) {
      ml_s[(warp * RM + m) * 2] = m_r[m];
      ml_s[(warp * RM + m) * 2 + 1] = l_r[m];
    }
    if (grp == 0)
#pragma unroll
      for (int e = 0; e < C::kVe; ++e)
        o_s[(warp * RM + m) * D + sl * C::kVe + e] = o[m][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += kCcThreads) {
    const int m = i / D, d = i - m * D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kCcWarps; ++w)
      mm = fmaxf(mm, ml_s[(w * RM + m) * 2]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kCcWarps; ++w) {
      // a warp that saw no key of the row holds (-1e30, 0, 0)
      const float e = ex2(ml_s[(w * RM + m) * 2] - mm);
      l = fmaf(ml_s[(w * RM + m) * 2 + 1], e, l);
      acc = fmaf(o_s[(w * RM + m) * D + d], e, acc);
    }
    if (part < 0) {
      store(out + out_row(a, t0, m, g) * D + d, acc / fmaxf(l, 1e-30f));
    } else {
      const size_t at = ((size_t)part * a.n_kv + g) * a.rm + m;
      a.part_o[at * D + d] = acc;
      if (d == 0) {
        a.part_ml[at * 2] = mm;
        a.part_ml[at * 2 + 1] = l;
      }
    }
  }
  if (part >= 0) {
    // publish the partials, then take a ticket; the last split merges
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(&a.tickets[part0 * a.n_kv + g], 1) == n_split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int i = threadIdx.x; i < R * D; i += kCcThreads) {
      const int m = i / D, d = i - m * D;
      float mm = kNegInf;
      for (int s = 0; s < n_split; ++s)
        mm = fmaxf(mm, __ldcg(a.part_ml + (((size_t)(part0 + s) * a.n_kv +
                                            g) * a.rm + m) * 2));
      float l = 0.f, acc = 0.f;
      for (int s = 0; s < n_split; ++s) {
        const size_t at = ((size_t)(part0 + s) * a.n_kv + g) * a.rm + m;
        const float e = ex2(__ldcg(a.part_ml + at * 2) - mm);
        l = fmaf(__ldcg(a.part_ml + at * 2 + 1), e, l);
        acc = fmaf(__ldcg(a.part_o + at * D + d), e, acc);
      }
      store(out + out_row(a, t0, m, g) * D + d, acc / fmaxf(l, 1e-30f));
    }
    if (threadIdx.x == 0) a.tickets[part0 * a.n_kv + g] = 0;
  }
  if (g == 0 && (int)threadIdx.x < n_tok)
    a.work[t0 + threadIdx.x] = work_of(a.bounds[t0 + threadIdx.x], a);
}

template <typename T, int D, int RM>
__global__ void __launch_bounds__(kCcThreads) paged_cc_kernel(Args a) {
  cc_block<T, D, RM>(a, blockIdx.x);
}

// ---- tensor cores: prefill units in bfloat16 -------------------------------

// Keys [c0, c0 + 64) of `row` (kv head g) into the swizzled K and V tiles,
// gathered page by page through the table; keys at or past n_keys, and
// pages outside the pool, read as zeros.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t sk, uint32_t sv,
                                        const Args& a, int row, int g,
                                        int c0, int n_keys) {
  constexpr int kChunks = D / 8;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v);
  for (int i = threadIdx.x; i < kTcKeys * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int key = c0 + r;
    bool ok = key < n_keys;
    size_t at = 0;
    if (ok) {
      const int page = a.page_table[(size_t)row * a.W + key / a.P];
      ok = page >= 0 && page < a.n_pages;
      at = ((((size_t)page * a.P + key % a.P) * a.n_kv + g) * D) + c * 8;
    }
    cp_async16(sk + sw128_at(r, c, kTcKeys), kp + (ok ? at : 0), ok);
    cp_async16(sv + sw128_at(r, c, kTcKeys), vp + (ok ? at : 0), ok);
  }
}

// A unit of up to 64 q rows of one row's prefill run, one kv head: Q
// resident, the keys of [0, n_keys) streamed 64 at a time; per tile
// S = Q.K^T, the online softmax on S in registers, O = alpha * O and
// O += P.V with P rounded to bf16 in registers, issued one tile late so
// that it runs while the next tile's softmax does.
template <int D>
__device__ __forceinline__ void tc_block(const Args& a, int b) {
  constexpr uint32_t kT = tc_tile<D>(64);
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sq = (smem_u32(smem_tc) + 1023u) & ~1023u;  // Q [64]
  const uint32_t sk = sq + kT;                 // K [kTcStagesK][64]
  const uint32_t sv = sk + kTcStagesK * kT;    // V [kTcStagesV][64]

  const int* u = units(a) + b * kUnitInts;
  const int t0 = u[0], n_tok = u[1], row = u[2], n_keys = u[3],
            min_keys = u[4];
  const int g = blockIdx.y;
  const int R = n_tok * a.fold;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);

  // Q's live rows (token x folded head), zeros below them
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTcRows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < R;
    cp_async16(sq + sw128_at(r, c, kTcRows),
               q + (ok ? out_row(a, t0, r, g) * D + c * 8 : 0), ok);
  }
  load_kv<D>(sk, sv, a, row, g, 0, n_keys);
  cp_async_commit();
  int bnd[2];  // the bounds of this thread's rows row0, row0 + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = row0 + 8 * hh;
    bnd[hh] = m < R ? min(a.bounds[t0 + m / a.fold], a.W * a.P) : 0;
  }
  const int n_tiles = (n_keys + kTcKeys - 1) / kTcKeys;

  float o[D / 2], s[32], mrow[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = kTcKeys * it;
    const uint32_t kt = sk + (it % kTcStagesK) * kT;
    cp_async_wait_all();
    fence_proxy_async();
    // tile it is in; the stages tile it + 1 loads into were last read by
    // tile it - 1's S (K) and tile it - 2's O product (V), which the
    // waits in tile it - 1 saw finish
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_kv<D>(sk + ((it + 1) % kTcStagesK) * kT,
                 sv + ((it + 1) % kTcStagesV) * kT, a, row, g, c0 + kTcKeys,
                 n_keys);
      cp_async_commit();
    }
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k(sq, 64, kk), desc_k(kt, 64, kk), kk);
    wgmma_commit();
    if (it > 0) {
      const uint32_t vt = sv + ((it - 1) % kTcStagesV) * kT;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[kk], desc_mn(vt, 64, kk));
      wgmma_commit();
      wgmma_wait<1>();  // S is in; the last tile's O product may still run
    } else {
      wgmma_wait<0>();
    }
    fence_acc(s);
    // only a tile that crosses some live row's bound is masked
    const bool edge = c0 + kTcKeys > min_keys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          if (edge && c0 + 8 * j + col0 + e >= bnd[hh]) s[i] = kNegInf;
          mx[hh] = fmaxf(mx[hh], s[i]);
        }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 2));
      const float m_new = fmaxf(mrow[hh], mx[hh] * a.scale2);
      alpha[hh] = ex2(mrow[hh] - m_new);
      mrow[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          s[i] = ex2(fmaf(s[i], a.scale2, -mrow[hh]));
          if (edge && c0 + 8 * j + col0 + e >= bnd[hh]) s[i] = 0.f;
          l[hh] += s[i];
        }
    wgmma_wait<0>();  // the last tile's O product is in
    fence_acc(o);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_a(s, pa);
  }
  if (n_tiles > 0) {
    wgmma_fence();
    const uint32_t vt = sv + ((n_tiles - 1) % kTcStagesV) * kT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[kk], desc_mn(vt, 64, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
  }
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
    const int m = row0 + 8 * hh;
    if (m >= R) continue;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    bf16* orow = out + out_row(a, t0, m, g) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                o[4 * j + 2 * hh + 1] * inv);
  }
  if (g == 0 && (int)threadIdx.x < n_tok)
    a.work[t0 + threadIdx.x] = work_of(a.bounds[t0 + threadIdx.x], a);
}

// bfloat16: the tensor-core units and the CUDA-core units (and pads) of a
// call in ONE launch, tc blocks first, so that a mixed step's prefill and
// decode units share the SMs instead of following each other.
template <int D, int RM>
__global__ void __launch_bounds__(kTcThreads) paged_cc_tc_kernel(Args a) {
  if ((int)blockIdx.x >= a.n_tc)
    cc_block<__nv_bfloat16, D, RM>(a, blockIdx.x - a.n_tc);
  else if ((int)blockIdx.x < a.sched[0])
    tc_block<D>(a, blockIdx.x);
}

// ---- launches ----------------------------------------------------------------

template <int D>
constexpr size_t tc_smem_bytes() {
  return 1024 + (1 + kTcStagesK + kTcStagesV) * (size_t)tc_tile<D>(64);
}
template <typename T, int D, int RM>
constexpr size_t cc_smem_bytes() {
  const size_t ring = (size_t)kCcWarps * kRing * Cc<T, D>::kStage * sizeof(T);
  const size_t merge = (size_t)kCcWarps * RM * (D + 2) * sizeof(float);
  return (size_t)RM * D * sizeof(float) + (ring > merge ? ring : merge);
}
static_assert(tc_smem_bytes<128>() <= 232448 &&
                  cc_smem_bytes<float, 128, kCcRows>() <= 232448,
              "a kernel asks for more shared memory than a block has");

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kCcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// blocks of the CUDA-core units and the pads
__host__ __device__ constexpr int cc_blocks(int n_cc, int n_pad) {
  return n_cc + (n_pad + kPadTokens - 1) / kPadTokens;
}

// bfloat16 with at most RM = 4 q rows a CUDA-core unit: both kinds of
// unit in one launch
template <int D, int RM>
cudaError_t run_bf16(const Args& a, cudaStream_t s) {
  const int n_cc = cc_blocks(a.n_cc, a.n_pad);
  size_t smem = a.n_tc > 0 ? tc_smem_bytes<D>() : 0;
  if (n_cc > 0 && cc_smem_bytes<__nv_bfloat16, D, RM>() > smem)
    smem = cc_smem_bytes<__nv_bfloat16, D, RM>();
  return launch(paged_cc_tc_kernel<D, RM>, dim3(a.n_tc + n_cc, a.n_kv),
                smem, a, s);
}

template <typename T, int D, int RM>
cudaError_t run_cc(const Args& a, cudaStream_t s) {
  return launch(paged_cc_kernel<T, D, RM>,
                dim3(cc_blocks(a.n_cc, a.n_pad), a.n_kv),
                cc_smem_bytes<T, D, RM>(), a, s);
}

// With 16 q rows a CUDA-core unit (a GQA fold above 4) those units take a
// launch of their own: their accumulators would otherwise cost the
// tensor-core units registers (and spill).
template <int D>
cudaError_t run_bf16(const Args& a, cudaStream_t s) {
  if (a.rm == 1) return run_bf16<D, 1>(a, s);
  if (a.rm == 4) return run_bf16<D, 4>(a, s);
  if (a.n_tc > 0) {
    Args tc = a;  // the tensor-core units alone
    tc.n_cc = tc.n_pad = 0;
    const cudaError_t e = run_bf16<D, 1>(tc, s);
    if (e != cudaSuccess) return e;
  }
  if (cc_blocks(a.n_cc, a.n_pad) == 0) return cudaSuccess;
  return run_cc<__nv_bfloat16, D, kCcRows>(a, s);
}

template <int D>
cudaError_t run_f32(const Args& a, cudaStream_t s) {
  if (a.n_tc > 0) return cudaErrorInvalidValue;  // tensor cores: bf16 only
  if (cc_blocks(a.n_cc, a.n_pad) == 0) return cudaSuccess;
  if (a.rm == 1) return run_cc<float, D, 1>(a, s);
  if (a.rm == 4) return run_cc<float, D, 4>(a, s);
  return run_cc<float, D, kCcRows>(a, s);
}

}  // namespace

extern "C" {

// The layout the host's schedule must agree with: ints of a schedule row,
// q rows of a tensor-core unit and of a CUDA-core unit, pad tokens a
// block zeroes, keys of a chunk (the page size's divisor), ints of the
// table's header.
void paged_attention_layout(int* out) {
  out[0] = kUnitInts;
  out[1] = kTcRows;
  out[2] = kCcRows;
  out[3] = kPadTokens;
  out[4] = kKeys;
  out[5] = kHeaderInts;
}

// sched: the device copy of a ragged_schedule table (a header of the live
// counts, then room for n_tc tensor-core rows, n_cc CUDA-core rows and
// n_pad pad token ids, the live ones first); rows_max (1, 4 or 16) bounds
// a CUDA-core unit's q rows; part_ml, part_o: the split units' scratch;
// tickets: one int per (split unit, kv head), zero before the call and
// zero again after it. The launch depends on the layout alone. dtype:
// 0 = float32, 1 = bfloat16 (q, pools and out share it). head_dim: 64 or
// 128. Returns a cudaError_t value (0 = launched).
int paged_attention_ragged(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* bounds, const void* sched, void* out,
                           void* work, void* part_ml, void* part_o,
                           void* tickets, int n_heads, int n_kv_heads,
                           int head_dim, int n_pages, int page_size,
                           int table_width, int n_tc, int n_cc, int n_pad,
                           int rows_max, float scale, int dtype,
                           void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kCcRows || page_size <= 0 ||
      page_size % kKeys != 0 ||
      (rows_max != 1 && rows_max != 4 && rows_max != kCcRows))
    return (int)cudaErrorInvalidValue;
  if (n_tc + n_cc + n_pad == 0) return (int)cudaSuccess;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(page_table),
               static_cast<const int*>(bounds),
               static_cast<const int*>(sched), out, static_cast<int*>(work),
               static_cast<float*>(part_ml), static_cast<float*>(part_o),
               static_cast<int*>(tickets), n_heads, n_kv_heads,
               n_heads / n_kv_heads, n_pages, page_size, table_width, n_tc,
               n_cc, n_pad, rows_max, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return (int)run_f32<64>(a, s);
  if (dtype == 0 && head_dim == 128) return (int)run_f32<128>(a, s);
  if (dtype == 1 && head_dim == 64) return (int)run_bf16<64>(a, s);
  if (dtype == 1 && head_dim == 128) return (int)run_bf16<128>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
