// The tree epilogue's leaf update for Hopper (sm_90a): one launch updates
// every leaf of a group of the step (SGD, Momentum, Nesterov, Adam and
// AdamW), with stochastic rounding in registers.
//
// Replaces no Pallas kernel. It computes what the reference's tree
// update computes for the four optimizers with a fused mapping
// (paddle_tpu/optimizer/optimizer.py `apply_gradients_tree`: each leaf's
// `upd()` with its `down()` and the found_inf select, which XLA fuses
// into one loop a leaf): decoupled decay, the optimizer's recurrence in
// float32, each bfloat16 state leaf and the parameter rounded back,
// stochastically under `_stochastic_rounding` (the bits of
// jax.random.bits(key, shape) at the leaf-local flat index i: threefry2x32
// of the count (0, i), the two words xor-ed; then
// (bits(x) + (bits_i & 0xffff)) >> 16 is the bf16), else to nearest even;
// a float32 master is written as it is and the parameter is its rounding
// to nearest even. Plain C interface, loaded with ctypes by
// paddle_tpu_torch/ops/kernels/tree_update.py, whose twin
// (`tree_update_reference`) runs the per-leaf torch code.
//
// Why a kernel: the per-leaf torch code is ~20 elementwise kernels a leaf
// (float32 copies of the param and grad, the recurrence in temporaries,
// the roundings, the select, the copies back), and the standalone
// stochastic-rounding kernel (stochastic_round.cu) reads its float32
// input from one of them. Here each element is read once and written
// once: bf16 param, grad and velocity in, bf16 param and velocity out, 10
// bytes for bench.py's GPT-1.3B Momentum.
//
// What bounds it: the threefry hashes. Two a parameter under stochastic
// rounding with one bf16 state (three with Adam's two), each 20 rounds of
// an add, a rotate and a xor plus 12 adds of the count and the key
// injections: 72 32-bit integer operations, 76 with the rounding, against
// ~20 for the update. At 10 bytes a parameter the bytes take ~3.9 ms for
// 1.31 G parameters; the integer work takes ~6.0 ms at the two pipes that
// take 32-bit integer instructions (64 lanes an SM a clock each: the
// integer pipe for shifts, logic and adds, the multiply-add pipe for
// integer multiply-adds). So the design keeps the integer instructions
// few, splits them over the two pipes and keeps enough warps resident to
// hide their latency:
// - the rotations are funnel shifts and the xors LOP3s (the integer
//   pipe); the adds are multiply-adds by a 1 read from constant memory
//   (IMAD, the multiply-add pipe), and an injection into x1 joins the
//   next round's add; the count's high word is 0 (leaves are below 2^31
//   elements); the truncation is one add and a shift;
// - a thread updates one vector of 8 elements a tile (16-byte loads and
//   stores of the bf16 streams, issued before the arithmetic: 8
//   independent pairs of hash chains), and the hashing variants keep
//   registers for 3 blocks of 256 threads an SM (`kMinBlocks`): 24 warps.
//   tools/kernel_ab.py `tree` measures the sizing alternatives (2 or 4
//   vectors a thread, 1-4 blocks an SM); rotations by the integer
//   multiplier and adds on the integer pipe were slower too (PERF.md);
// - a tile (256 threads x 8 elements) lies inside one leaf, so the leaf's
//   keys and scalars (its row of the step's scalars, apart from the leaf
//   table, so that a captured launch keeps the table and reads each
//   replay's scalars) load once a tile; tiles are found by a binary search
//   over the leaves' first tiles, staged in shared memory; the grid is
//   what the card keeps resident (measured occupancy) and walks the
//   tiles.
// Health sums (Sigma new_p^2, Sigma (new_p - old_p)^2 over the written
// params) come from registers: each thread sums its elements with fused
// multiply-adds, a warp by xor shuffles, thread 0 the warps in order, one
// partial a block; the last block to finish (a ticket counter) sums the
// partials in block order. Deterministic, one launch.
//
// Rounding: nvcc would contract a*b + c into an FMA where the twin rounds
// each product. Every value that is written is computed with __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn (IEEE), which match the
// twin's torch operations bit for bit. A bf16 state times its scalar is
// exact in float32 and rounded to bf16 once, as torch (and JAX) compute a
// bf16 product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec8.cuh"

// These structs stay outside the unnamed namespace: the C entry takes
// pointers to both, and a parameter type with internal linkage would give
// the entry internal linkage too (no exported symbol).

// one row of the leaf table (64 bytes): where the leaf's buffers lie,
// fixed while they stay there (a captured launch keeps it)
struct Leaf {
  long long g, p, s0, s1, mw;  // device addresses; 0 when absent
  long long n;                 // elements (below 2^31)
  long long tile0;             // the leaf's first tile in the launch
  int slot;                    // its row in the step's scalars
  int flags;                   // kAligned | kGradF32
};

// one leaf's row of the step's scalars (64 bytes), which change every
// step: read from device memory, so that a captured launch reads each
// replay's values (the train step's scalars block, jit/scalars.py)
struct Scal {
  unsigned key[8];  // threefry keys: the param's, state 0's, 1's, 2's
  float decay;      // decoupled decay factor (1 where it does not apply)
  float rate[7];    // float32 lr of the leaf, Adam's lr_t, unused
};

// the optimizer's float32 constants; *_s meet a state leaf (rounded to
// bf16 first for a bf16 state, JAX's weak-typed scalar)
struct TreeArgs {
  float mom, mom_s, b1_s, omb1, b2_s, omb2, eps;
  int nesterov, has_master, with_stats, accumulate;
};

namespace {

constexpr int kThreads = 256;
// blocks an SM the registers are kept for: kMinBlocks for the variants
// that hash (stochastic rounding) without Adam's second state, 2 for the
// others (Adam's would spill under the tighter cap)
constexpr int kMinBlocks = 3;
constexpr int kVecs = 1;       // 8-element vectors a thread a tile
constexpr int kTile = kThreads * kVecs * kVec;
constexpr int kMaxBlocksPerSm = 8;
constexpr int kAligned = 1;  // every buffer of the leaf 16-byte aligned
constexpr int kGradF32 = 2;  // the grad is float32 (else bfloat16)
constexpr int kSgd = 0, kMomentum = 1, kAdam = 2;

template <typename T>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

// threefry2x32's additions under one key: a[0], b[0] start the count
// words, a[r + 1], b[r + 1] are injection r (ks[j] and ks[j'] + r + 1)
struct SrKey {
  unsigned a[6], b[6];
};

__device__ __forceinline__ SrKey make_key(unsigned k1, unsigned k2) {
  const unsigned ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  SrKey k;
  k.a[0] = ks[0];
  k.b[0] = ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    k.a[r + 1] = ks[(r + 1) % 3];
    k.b[r + 1] = ks[(r + 2) % 3] + static_cast<unsigned>(r + 1);
  }
  return k;
}

// threefry2x32's rotations (group parity h, round j of the group)
__host__ __device__ constexpr int rot_of(int h, int j) {
  return h ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
           : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}
// a 1 the compiler cannot see, so that a * kOne + b stays a multiply-add
__constant__ unsigned kOne = 1;

// a + b as IMAD a * 1 + b: on the multiply-add pipe, off the integer pipe
// that takes the rotations and the xors
__device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
  return a * kOne + b;
}

// rotl(x2, rotation (h, j)) ^ x1
template <int H, int J>
__device__ __forceinline__ unsigned mix(unsigned x2, unsigned x1) {
  return __funnelshift_l(x2, x2, rot_of(H, J)) ^ x1;
}

// the 4 rounds of a group with the rotations of half H, the first
// round's add done by the caller
template <int H>
__device__ __forceinline__ void group(unsigned& x1, unsigned& x2) {
  x2 = mix<H, 0>(x2, x1);
  x1 = add(x1, x2);
  x2 = mix<H, 1>(x2, x1);
  x1 = add(x1, x2);
  x2 = mix<H, 2>(x2, x1);
  x1 = add(x1, x2);
  x2 = mix<H, 3>(x2, x1);
}

// the 32 random bits at flat index i: threefry2x32 (20 rounds) of the
// count (0, i), the two output words xor-ed (ops/threefry.py random_bits).
// An injection into x1 is added with the next round's x2 in one
// three-input add.
__device__ __forceinline__ unsigned sr_bits(const SrKey& k, unsigned i) {
  unsigned x2 = add(i, k.b[0]);
  unsigned x1 = add(x2, k.a[0]);  // the first round's add
  group<0>(x1, x2);
#pragma unroll
  for (int r = 1; r < 5; ++r) {
    x2 = add(x2, k.b[r]);
    // injection r - 1 and round 4r's add (one three-input add)
    x1 = add(add(x1, k.a[r]), x2);
    if (r % 2)
      group<1>(x1, x2);
    else
      group<0>(x1, x2);
  }
  return (x1 + k.a[5]) ^ (x2 + k.b[5]);
}

// x32 to M: stochastically rounded to bf16 with the bits at index i (the
// truncated float has no low bits left: its high half is the bf16), to
// nearest even without SR, unchanged for float32
template <typename M, bool SR>
__device__ __forceinline__ M down(float x, const SrKey& k, unsigned i) {
  if constexpr (SR && IsBf16<M>::value) {
    const unsigned r = sr_bits(k, i) & 0xFFFFu;
    return __ushort_as_bfloat16(
        static_cast<unsigned short>((__float_as_uint(x) + r) >> 16));
  } else {
    return from_f32<M>(x);
  }
}

// a state leaf times its scalar c: in float32 for a float32 state; for a
// bf16 state the exact float32 product of two bf16 values, rounded to
// bf16 (torch's bf16 product)
template <typename M>
__device__ __forceinline__ float state_product(float c, M s) {
  const float x = __fmul_rn(c, to_f32(s));
  if constexpr (IsBf16<M>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* ptr, int e, int n,
                                         bool vec, Vec8<T>& out) {
  if (vec && e + kVec <= n) {
    out = *reinterpret_cast<const Vec8<T>*>(ptr + e);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      out.v[i] = e + i < n ? ptr[e + i] : from_f32<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* ptr, int e, int n, bool vec,
                                          const Vec8<T>& x) {
  if (vec && e + kVec <= n) {
    *reinterpret_cast<Vec8<T>*>(ptr + e) = x;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (e + i < n) ptr[e + i] = x.v[i];
  }
}

// the leaf holding tile t: the last whose first tile is <= t
__device__ __forceinline__ int find_leaf(const int* tile0, int n, int t) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile0[mid] <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// block sum of x, valid in thread 0: lanes by xor shuffles, then thread 0
// adds the warps in order
__device__ __forceinline__ float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // smem may still be read by a previous call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = smem[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kThreads / 32; ++w) r += smem[w];
  return r;
}

// T: the params' type, M: the states', KIND: kSgd / kMomentum / kAdam
// (Adam and AdamW: AdamW's decay is the leaf's factor), SR: stochastic
// rounding of every bf16 target
__host__ __device__ constexpr int min_blocks(int kind, bool sr) {
  return sr && kind != kAdam ? kMinBlocks : 2;
}

template <typename T, typename M, int KIND, bool SR>
__global__ void __launch_bounds__(kThreads, min_blocks(KIND, SR))
    tree_update_kernel(const Leaf* __restrict__ leaves,
                       const Scal* __restrict__ scal, int n_leaves,
                       int n_tiles, const TreeArgs a,
                       const unsigned char* __restrict__ found_p,
                       float* __restrict__ partials,
                       unsigned* __restrict__ ticket,
                       float* __restrict__ out) {
  constexpr int kStates = KIND == kSgd ? 0 : KIND == kMomentum ? 1 : 2;
  extern __shared__ int tile0_s[];
  for (int i = threadIdx.x; i < n_leaves; i += kThreads)
    tile0_s[i] = static_cast<int>(leaves[i].tile0);
  __syncthreads();
  // the skip exists only under a live GradScaler (found_p non-null):
  // nothing is written, the sums see the old params
  const bool found = found_p != nullptr && *found_p != 0;
  if (found && !a.with_stats) return;
  float sp = 0.f, su = 0.f;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int li = find_leaf(tile0_s, n_leaves, t);
    const Leaf& L = leaves[li];
    const int n = static_cast<int>(L.n);
    const bool vec = (L.flags & kAligned) != 0;
    T* p = reinterpret_cast<T*>(L.p);
    M* s0 = reinterpret_cast<M*>(L.s0);
    M* s1 = reinterpret_cast<M*>(L.s1);
    float* mw = reinterpret_cast<float*>(L.mw);
    const int e0 = (t - tile0_s[li]) * kTile + threadIdx.x * kVec;
    float g[kVecs][kVec], mwx[kVecs][kVec];
    Vec8<T> px[kVecs];
    Vec8<M> s0x[kVecs], s1x[kVecs];
    // every load of the tile first; past the leaf's end they read zeros,
    // which update to zeros and add nothing to the sums
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int e = e0 + k * kThreads * kVec;
      if (e >= n) continue;
      if (L.flags & kGradF32)
        load8(reinterpret_cast<const float*>(L.g), e, n, vec, g[k]);
      else
        load8(reinterpret_cast<const __nv_bfloat16*>(L.g), e, n, vec, g[k]);
      load_vec(p, e, n, vec, px[k]);
      if (kStates > 0) load_vec(s0, e, n, vec, s0x[k]);
      if (kStates > 1) load_vec(s1, e, n, vec, s1x[k]);
      if (a.has_master) load8(mw, e, n, vec, mwx[k]);
    }
    const Scal& S = scal[L.slot];
    const float lr = S.rate[0], lr_t = S.rate[1], decay = S.decay;
    SrKey kp, k0, k1;
    if (SR) {
      kp = make_key(S.key[0], S.key[1]);
      k0 = make_key(S.key[2], S.key[3]);
      k1 = make_key(S.key[4], S.key[5]);
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int e = e0 + k * kThreads * kVec;
      if (e >= n) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const unsigned idx = static_cast<unsigned>(e + i);
        const float gv = g[k][i];
        const float old = to_f32(px[k].v[i]);
        // decoupled decay (factor 1 where it does not apply)
        const float w = __fmul_rn(a.has_master ? mwx[k][i] : old, decay);
        float np;
        if constexpr (KIND == kSgd) {
          np = __fsub_rn(w, __fmul_rn(lr, gv));
        } else if constexpr (KIND == kMomentum) {
          const float vel = __fadd_rn(state_product(a.mom_s, s0x[k].v[i]),
                                      gv);
          np = a.nesterov
                   ? __fsub_rn(w, __fmul_rn(lr, __fadd_rn(
                                          gv, __fmul_rn(a.mom, vel))))
                   : __fsub_rn(w, __fmul_rn(lr, vel));
          s0x[k].v[i] = down<M, SR>(vel, k0, idx);
        } else {
          const float m = __fadd_rn(state_product(a.b1_s, s0x[k].v[i]),
                                    __fmul_rn(a.omb1, gv));
          const float v = __fadd_rn(state_product(a.b2_s, s1x[k].v[i]),
                                    __fmul_rn(__fmul_rn(a.omb2, gv), gv));
          np = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr_t, m),
                                      __fadd_rn(__fsqrt_rn(v), a.eps)));
          s0x[k].v[i] = down<M, SR>(m, k0, idx);
          s1x[k].v[i] = down<M, SR>(v, k1, idx);
        }
        T newp;
        if (a.has_master) {
          newp = from_f32<T>(np);  // the master's rounding to nearest
          mwx[k][i] = np;
        } else {
          newp = down<T, SR>(np, kp, idx);
        }
        px[k].v[i] = newp;
        if (a.with_stats) {
          const float n32 = found ? old : to_f32(newp);
          const float d = __fsub_rn(n32, old);
          sp = fmaf(n32, n32, sp);
          su = fmaf(d, d, su);
        }
      }
      if (!found) {
        store_vec(p, e, n, vec, px[k]);
        if (kStates > 0) store_vec(s0, e, n, vec, s0x[k]);
        if (kStates > 1) store_vec(s1, e, n, vec, s1x[k]);
        if (a.has_master) store8(mw, e, n, vec, mwx[k]);
      }
    }
  }
  if (!a.with_stats) return;
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  const float s = block_sum(sp, red);
  const float u = block_sum(su, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    partials[gridDim.x + blockIdx.x] = u;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written; sum them in block order
  __threadfence();
  float x = 0.f, y = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    x += __ldcg(partials + b);
    y += __ldcg(partials + gridDim.x + b);
  }
  x = block_sum(x, red);
  y = block_sum(y, red);
  if (threadIdx.x == 0) {
    out[0] = a.accumulate ? out[0] + x : x;
    out[1] = a.accumulate ? out[1] + y : y;
    *ticket = 0u;  // ready for the next launch
  }
}

struct Launch {
  const Leaf* leaves;
  const Scal* scal;
  int n_leaves, n_tiles;
  const TreeArgs* args;
  const unsigned char* found;
  float* partials;
  unsigned* ticket;
  float* out;
  int sms;
  cudaStream_t stream;
};

// as many blocks as the card keeps resident (measured occupancy, at most
// kMaxBlocksPerSm an SM: the wrapper's partial slots), at most n_tiles
template <typename T, typename M, int KIND, bool SR>
int run(const Launch& l) {
  const size_t smem = static_cast<size_t>(l.n_leaves) * sizeof(int);
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tree_update_kernel<T, M, KIND, SR>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  long long grid = static_cast<long long>(l.sms) * per_sm;
  if (grid > l.n_tiles) grid = l.n_tiles;
  if (grid < 1) return static_cast<int>(cudaSuccess);
  tree_update_kernel<T, M, KIND, SR>
      <<<static_cast<int>(grid), kThreads, smem, l.stream>>>(
          l.leaves, l.scal, l.n_leaves, l.n_tiles, *l.args, l.found,
          l.partials, l.ticket, l.out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M, int KIND>
int by_sr(int sr, const Launch& l) {
  return sr ? run<T, M, KIND, true>(l) : run<T, M, KIND, false>(l);
}

// SGD keeps no state: one variant a param type
template <typename T>
int by_kind(int kind, int state_dtype, int sr, const Launch& l) {
  using bf16 = __nv_bfloat16;
  if (kind == kSgd) return by_sr<T, float, kSgd>(sr, l);
  if (kind == kMomentum)
    return state_dtype == 1 ? by_sr<T, bf16, kMomentum>(sr, l)
                            : by_sr<T, float, kMomentum>(sr, l);
  return state_dtype == 1 ? by_sr<T, bf16, kAdam>(sr, l)
                          : by_sr<T, float, kAdam>(sr, l);
}

}  // namespace

extern "C" {

// the tiling the wrapper must agree with: threads, elements per vector,
// vectors a thread a tile, blocks an SM at most (partial slots)
void tree_update_tiling(int* out) {
  out[0] = kThreads;
  out[1] = kVec;
  out[2] = kVecs;
  out[3] = kMaxBlocksPerSm;
}

// leaves: the group's table (n_leaves rows; tiles of kTile elements, tile0
// their running sum, n_tiles in all); scal: the step's scalars, one row a
// leaf of the step (a leaf reads row `slot`); kind: 0 sgd, 1 momentum (Nesterov
// in args), 2 adam / adamw; sr: stochastic rounding; dtype / state_dtype:
// the params' / the states' (0 float32, 1 bfloat16); found: the
// GradScaler's bool flag or null; partials: 2 * sms * kMaxBlocksPerSm
// floats; ticket: one zeroed unsigned (left zeroed); out: the two sums
// (written, or added to with args->accumulate) when args->with_stats.
// Returns the launch's cudaError_t.
int tree_update(const void* leaves, const void* scal, int n_leaves,
                int n_tiles, const TreeArgs* args, const void* found,
                float* partials, void* ticket, float* out, int kind, int sr,
                int dtype, int state_dtype, int sms, void* stream) {
  if (n_tiles <= 0 || n_leaves <= 0) return static_cast<int>(cudaSuccess);
  const Launch l{static_cast<const Leaf*>(leaves),
                 static_cast<const Scal*>(scal),
                 n_leaves,
                 n_tiles,
                 args,
                 static_cast<const unsigned char*>(found),
                 partials,
                 static_cast<unsigned*>(ticket),
                 out,
                 sms,
                 static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return by_kind<__nv_bfloat16>(kind, state_dtype, sr, l);
  return by_kind<float>(kind, state_dtype, sr, l);
}

}  // extern "C"
