// The fused optimizer epilogue for Hopper (sm_90a): kernels #9 and #10.
//
// Replaces paddle_tpu/ops/pallas/fused_update.py `_pass1_kernel` (pass 1:
// unscale, weighted L2 partial sums, non-finite sweep) and
// `_pass2_kernel` (pass 2: clip, decoupled decay, the AdamW / Adam /
// Momentum / SGD recurrence, master downcast, found_inf select, health
// sums), with the math of `_pass1_math`, `_pass2_math` and
// `_update_core`. Plain C interface, loaded with ctypes by
// paddle_tpu_torch/ops/kernels/fused_update.py, whose twins
// (`fused_pass1_reference`, `fused_pass2_reference`) compute the same
// function with torch's elementwise ops.
//
// What bounds it: device-memory bytes. Pass 1 reads the grads once (2
// bytes a bf16 parameter; with a live GradScaler it writes them back
// unscaled); pass 2 reads grad, param, two moments and the master and
// writes param, moments and master: 30 bytes a bf16 parameter with f32
// masters and f32 moments, 22 with bf16 moments (the optimizer's
// `_state_dtype`), ~0.1 operations a byte. So the design is about bytes in
// flight: every load and store is a 16-byte vector (8 bf16 or 4 f32), and
// each thread issues all the loads of UNROLL vectors before it computes
// (pass 1: 4 vectors of the grad; pass 2: 2 units of 8 elements, 16
// vectors). wgmma and TMA have no role.
//
// Design, against the TPU kernel's sequential grid with a scratch
// accumulator:
// - One launch sweeps every bucket of a group (same param dtype, same
//   has-master), not one launch per bucket. A block walks tiles
//   t = blockIdx.x, + gridDim.x, ...; a tile lies inside one bucket (pass
//   2) or one run (pass 1), found by binary search over the tiles'
//   starts, and covers THREADS * UNROLL vectors of 8 elements,
//   consecutive threads on consecutive vectors. Only a bucket's (a run's)
//   last vector can be partial and takes scalar loads.
// - Pass 1 needs one number of the metadata, the L2 weight
//   norm_weight * need_clip, and a bucket's is uniform by construction.
//   So the wrapper cuts each bucket into runs of one weight (one run a
//   bucket from BucketLayout) and pass 1 reads a table of runs (Seg1),
//   staged in shared memory once a block; a tile reads its weight once.
//   Its grid is what the card keeps resident (measured occupancy).
// - Pass 2's per-leaf metadata (need_clip / decay flags, lr_scale,
//   norm_weight) comes through the chunk -> leaf table, once per
//   8-element vector, from a device-resident descriptor table (built once
//   by the wrapper) of each bucket's addresses, length, first chunk row
//   and first tile. A vector that straddles two chunks of one bucket reads
//   the same values from either.
// - Sums stay on the device and are deterministic. Order: each thread
//   sums its vectors' terms in order; a warp adds lanes by xor shuffles;
//   thread 0 adds the 8 warps in order and writes one partial per block
//   (fields stored [field][slot]); `fused_finalize` (one block) then
//   sums the slots, each thread a strided run in order, then a fixed
//   tree. No float atomics. found is a max of 0/1 flags.
// - Moments are float32 or bfloat16 (a template parameter of pass 2):
//   a bf16 moment is loaded, widened to float32 for the math and stored
//   with __float2bfloat16_rn, the reference's `astype` (round to nearest
//   even). Masters are always float32.
// - Rounding: nvcc would contract a*b + c into an FMA, and the twins
//   run separate torch ops that round each product. So every value a
//   pass writes is computed with __fmul_rn / __fadd_rn / __fsub_rn /
//   __fdiv_rn / __fsqrt_rn (IEEE), which match the twins bit for bit.
//   Sums need only agree to float32 rounding: pass 1 takes them with
//   fused multiply-adds, one chain per vector.
// - In place: pass 1 writes the unscaled grads over the grads (nothing
//   reads the raw grads after it); pass 2 writes params, moments and
//   masters over themselves, each element read and then written by the
//   same thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "vec8.cuh"

// These structs stay outside the unnamed namespace: fused_pass2's C
// entry takes a Pass2Args, and a parameter type with internal linkage
// would give the entry internal linkage too (no exported symbol).

// one row of pass 2's descriptor table: 8 int64 written by the wrapper
struct Bucket {
  long long g, p, m0, m1, mw;  // device addresses; 0 when absent
  long long n;                 // elements
  long long chunk0;            // the bucket's first row in chunk_leaf
  long long tile2;             // its first tile in pass 2
};

// one row of pass 1's table (4 int64 written by the wrapper): a run of
// one bucket's grads whose leaves share one L2 weight; one run per
// bucket when the bucket's metadata is uniform, as BucketLayout makes it
struct Seg1 {
  long long g;     // device address of the run's first grad (16-byte aligned)
  long long n;     // elements
  long long tile;  // its first tile
  float w;         // norm_weight * need_clip of its leaves
  int unused;
};

// the step's constants; the rates that change from step to step (lr and
// Adam's bias-corrected lr_t) are read from device memory (`rates`), so
// that a captured launch reads each replay's values
struct Pass2Args {
  float wd, b1, b2, omb1, omb2, eps, mom, clip_norm, lo, hi;
  int kind;  // 0 sgd, 1 momentum, 2 adam / adamw
  int nesterov, n_moments, has_master, global_clip, value_clip,
      with_stats;
};

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll1 = 4;
constexpr int kUnroll2 = 2;
constexpr int kFinalizeThreads = 1024;
constexpr int kFlagNeedClip = 1;
constexpr int kFlagDecay = 2;

template <typename T>
__device__ __forceinline__ void load8(const T* ptr, long long base,
                                      long long n, Vec8<T>& out) {
  if (base + kVec <= n) {
    out = *reinterpret_cast<const Vec8<T>*>(ptr + base);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      out.v[i] = base + i < n ? ptr[base + i] : from_f32<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* ptr, long long base, long long n,
                                       const Vec8<T>& x) {
  if (base + kVec <= n) {
    *reinterpret_cast<Vec8<T>*>(ptr + base) = x;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (base + i < n) ptr[base + i] = x.v[i];
  }
}

// the bucket holding tile t: the last whose first tile is <= t
__device__ __forceinline__ int find_bucket(const Bucket* desc, int nb,
                                           long long t) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    const long long s = desc[mid].tile2;
    if (s <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// jnp.maximum / jnp.minimum: a NaN operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// block sum (or max) of x; the result is valid in thread 0
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // smem may still be read by a previous call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = smem[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kThreads / 32; ++w)
      r = kMax ? fmaxf(r, smem[w]) : r + smem[w];
  return r;
}

// the segment holding tile t: the last whose first tile is <= t
__device__ __forceinline__ int find_seg(const Seg1* segs, int ns,
                                        long long t) {
  int lo = 0, hi = ns - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[mid].tile <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Pass 1 over runs of uniform weight (Seg1): the table is staged in
// shared memory once a block; a tile reads its weight once, after its
// loads are issued. Each thread keeps kUnroll1 16-byte vectors in flight,
// with one sum chain per vector. The unscale (kWriteU) is a template
// argument: the main path, with no scaler, keeps no value to write back.
template <typename T, bool kWriteU>
__global__ void __launch_bounds__(kThreads)
    fused_pass1_kernel(const Seg1* __restrict__ segs, int ns,
                       long long n_tiles, const float* __restrict__ scale,
                       float* __restrict__ partials, long long stride) {
  extern __shared__ Seg1 seg_s[];
  for (int i = threadIdx.x; i < ns; i += kThreads) seg_s[i] = segs[i];
  __syncthreads();
  const float inv = kWriteU ? __fdiv_rn(1.f, *scale) : 1.f;
  float ss = 0.f;
  bool nonfin = false;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Seg1 sg = seg_s[find_seg(seg_s, ns, t)];
    T* g = reinterpret_cast<T*>(sg.g);
    const long long unit0 = (t - sg.tile) * (kThreads * kUnroll1);
    Vec8<T> x[kUnroll1];
#pragma unroll
    for (int k = 0; k < kUnroll1; ++k) {
      const long long base = (unit0 + k * kThreads + threadIdx.x) * kVec;
      if (base < sg.n) {
        load8(g, base, sg.n, x[k]);  // zeros past the run's end
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) x[k].v[i] = from_f32<T>(0.f);
      }
    }
    float part[kUnroll1];
#pragma unroll
    for (int k = 0; k < kUnroll1; ++k) {
      part[k] = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float g32 = to_f32(x[k].v[i]);
        // found_inf sweeps the raw grads, before the unscale
        nonfin |= !isfinite(g32);
        float u32 = g32;
        if (kWriteU) {
          const T u = from_f32<T>(__fmul_rn(g32, inv));
          x[k].v[i] = u;
          u32 = to_f32(u);
        }
        part[k] = fmaf(u32, u32, part[k]);
      }
      if (kWriteU) {
        const long long base = (unit0 + k * kThreads + threadIdx.x) * kVec;
        if (base < sg.n) store8(g, base, sg.n, x[k]);
      }
    }
#pragma unroll
    for (int k = 1; k < kUnroll1; ++k) part[0] += part[k];
    // _pass1_math: w = norm_weight * need_clip, uniform over the run
    ss = fmaf(sg.w, part[0], ss);
  }
  __shared__ float smem[kThreads / 32];
  const float s = block_reduce<false>(ss, smem);
  const float f = block_reduce<true>(nonfin ? 1.f : 0.f, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    partials[stride + blockIdx.x] = f;
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads)
    fused_pass2_kernel(const Bucket* __restrict__ desc, int nb,
                       long long n_tiles, const int* __restrict__ chunk_leaf,
                       const int* __restrict__ flags,
                       const float* __restrict__ lrs,
                       const float* __restrict__ nw, long long chunk,
                       const Pass2Args a, const float* __restrict__ rates,
                       const float* __restrict__ sumsq,
                       const float* __restrict__ found_p,
                       float* __restrict__ partials, long long stride) {
  // the skip exists only under a live GradScaler (found_p non-null)
  const bool found = found_p != nullptr && *found_p > 0.f;
  const float lr0 = rates[0], lr_t0 = rates[1];
  float clip_f = 1.f;
  if (a.global_clip) {
    const float gn = __fsqrt_rn(*sumsq);
    clip_f = nan_min(__fdiv_rn(a.clip_norm, nan_max(gn, 1e-12f)), 1.f);
  }
  float sp = 0.f, su = 0.f;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Bucket bk = desc[find_bucket(desc, nb, t)];
    T* g = reinterpret_cast<T*>(bk.g);
    T* p = reinterpret_cast<T*>(bk.p);
    M* m0 = reinterpret_cast<M*>(bk.m0);
    M* m1 = reinterpret_cast<M*>(bk.m1);
    float* mw = reinterpret_cast<float*>(bk.mw);
    const long long unit0 = (t - bk.tile2) * (kThreads * kUnroll2);
    Vec8<T> gx[kUnroll2], px[kUnroll2];
    Vec8<M> m0x[kUnroll2], m1x[kUnroll2];
    Vec8<float> mwx[kUnroll2];
#pragma unroll
    for (int k = 0; k < kUnroll2; ++k) {
      const long long base = (unit0 + k * kThreads + threadIdx.x) * kVec;
      if (base >= bk.n) continue;
      load8(g, base, bk.n, gx[k]);
      load8(p, base, bk.n, px[k]);
      if (a.n_moments > 0) load8(m0, base, bk.n, m0x[k]);
      if (a.n_moments > 1) load8(m1, base, bk.n, m1x[k]);
      if (a.has_master) load8(mw, base, bk.n, mwx[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll2; ++k) {
      const long long base = (unit0 + k * kThreads + threadIdx.x) * kVec;
      if (base >= bk.n) continue;
      const int leaf = chunk_leaf[bk.chunk0 + base / chunk];
      const int fl = flags[leaf];
      const float lr = __fmul_rn(lr0, lrs[leaf]);
      const float lr_t = __fmul_rn(lr_t0, lrs[leaf]);
      const float decay = (a.wd != 0.f && (fl & kFlagDecay))
                              ? __fsub_rn(1.f, __fmul_rn(lr, a.wd))
                              : 1.f;
      const float cf = (fl & kFlagNeedClip) ? clip_f : 1.f;
      float psum = 0.f, usum = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (base + i >= bk.n) break;
        T gv = gx[k].v[i];
        if (a.global_clip) gv = from_f32<T>(__fmul_rn(to_f32(gv), cf));
        if (a.value_clip) {
          // bounds arrive rounded to T; NaN passes through
          const float c = to_f32(gv);
          if (c < a.lo)
            gv = from_f32<T>(a.lo);
          else if (c > a.hi)
            gv = from_f32<T>(a.hi);
        }
        const float g32 = to_f32(gv);
        const float p32 = to_f32(px[k].v[i]);
        const float w = __fmul_rn(a.has_master ? mwx[k].v[i] : p32, decay);
        float np, nm0 = 0.f, nm1 = 0.f;
        if (a.kind == 2) {  // adam / adamw
          nm0 = __fadd_rn(__fmul_rn(a.b1, to_f32(m0x[k].v[i])),
                          __fmul_rn(a.omb1, g32));
          nm1 = __fadd_rn(__fmul_rn(a.b2, to_f32(m1x[k].v[i])),
                          __fmul_rn(__fmul_rn(a.omb2, g32), g32));
          np = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr_t, nm0),
                                      __fadd_rn(__fsqrt_rn(nm1), a.eps)));
        } else if (a.kind == 1) {  // momentum
          nm0 = __fadd_rn(__fmul_rn(a.mom, to_f32(m0x[k].v[i])), g32);
          np = a.nesterov
                   ? __fsub_rn(w, __fmul_rn(lr, __fadd_rn(
                                          g32, __fmul_rn(a.mom, nm0))))
                   : __fsub_rn(w, __fmul_rn(lr, nm0));
        } else {  // sgd
          np = __fsub_rn(w, __fmul_rn(lr, g32));
        }
        // the downcast, then the branchless found_inf select
        const T old_p = px[k].v[i];
        const T new_p = found ? old_p : from_f32<T>(np);
        px[k].v[i] = new_p;
        if (a.n_moments > 0 && !found) m0x[k].v[i] = from_f32<M>(nm0);
        if (a.n_moments > 1 && !found) m1x[k].v[i] = from_f32<M>(nm1);
        if (a.has_master && !found) mwx[k].v[i] = np;
        if (a.with_stats) {
          const float s32 = to_f32(new_p);
          const float d = __fsub_rn(s32, p32);
          psum = __fadd_rn(psum, __fmul_rn(s32, s32));
          usum = __fadd_rn(usum, __fmul_rn(d, d));
        }
      }
      if (a.with_stats) {
        sp = __fadd_rn(sp, __fmul_rn(nw[leaf], psum));
        su = __fadd_rn(su, __fmul_rn(nw[leaf], usum));
      }
      store8(p, base, bk.n, px[k]);
      if (a.n_moments > 0) store8(m0, base, bk.n, m0x[k]);
      if (a.n_moments > 1) store8(m1, base, bk.n, m1x[k]);
      if (a.has_master) store8(mw, base, bk.n, mwx[k]);
    }
  }
  if (!a.with_stats) return;
  __shared__ float smem[kThreads / 32];
  const float s = block_reduce<false>(sp, smem);
  const float u = block_reduce<false>(su, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    partials[stride + blockIdx.x] = u;
  }
}

// out[f] = sum (or max, bit f of max_mask) over the n_slots partials of
// field f, in a fixed order; out[n_fields] = sqrt(out[0]) if with_sqrt
__global__ void __launch_bounds__(kFinalizeThreads)
    fused_finalize_kernel(const float* __restrict__ partials,
                          long long n_slots, int n_fields, int max_mask,
                          int with_sqrt, float* __restrict__ out) {
  __shared__ float smem[kFinalizeThreads];
  for (int f = 0; f < n_fields; ++f) {
    const bool is_max = (max_mask >> f) & 1;
    float acc = 0.f;
    for (long long s = threadIdx.x; s < n_slots; s += kFinalizeThreads) {
      const float v = partials[f * n_slots + s];
      acc = is_max ? fmaxf(acc, v) : acc + v;
    }
    smem[threadIdx.x] = acc;
    __syncthreads();
    for (int h = kFinalizeThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) {
        const float o = smem[threadIdx.x + h];
        smem[threadIdx.x] =
            is_max ? fmaxf(smem[threadIdx.x], o) : smem[threadIdx.x] + o;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) out[f] = smem[0];
    __syncthreads();
  }
  if (with_sqrt && threadIdx.x == 0) out[n_fields] = __fsqrt_rn(out[0]);
}

// Pass 1's launch: as many blocks as the card keeps resident at once
// (measured occupancy), at most max_grid (the group's slots) and n_tiles.
template <typename T, bool kWriteU>
int run_pass1(const Seg1* segs, int ns, long long n_tiles,
              const float* scale, float* partials, long long stride,
              int max_grid, void* stream) {
  const size_t smem = (size_t)ns * sizeof(Seg1);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_pass1_kernel<T, kWriteU>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > max_grid) grid = max_grid;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return static_cast<int>(cudaSuccess);
  if (grid < max_grid) {
    // the finalize sums all max_grid slots of the group: zero the ones
    // this grid leaves unwritten (an earlier launch of the other template,
    // at another occupancy, may have filled them)
    const size_t tail = (size_t)(max_grid - grid) * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    e = cudaMemsetAsync(partials + grid, 0, tail, s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(partials + stride + grid, 0, tail, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_pass1_kernel<T, kWriteU>
      <<<(int)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          segs, ns, n_tiles, scale, partials, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M>
int run_pass2(const Bucket* d, int nb, long long n_tiles,
              const int* chunk_leaf, const int* flags, const float* lrs,
              const float* nw, long long chunk, const Pass2Args& a,
              const float* rates, const float* sumsq, const float* found,
              float* partials, long long stride, int grid, cudaStream_t s) {
  fused_pass2_kernel<T, M><<<grid, kThreads, 0, s>>>(
      d, nb, n_tiles, chunk_leaf, flags, lrs, nw, chunk, a, rates, sumsq,
      found, partials, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the tiling the wrapper must agree with: threads, elements per vector,
// vectors a thread a tile in pass 1 and in pass 2
void fused_update_tiling(int* out) {
  out[0] = kThreads;
  out[1] = kVec;
  out[2] = kUnroll1;
  out[3] = kUnroll2;
}

// dtype: 0 float32, 1 bfloat16. segs: the group's Seg1 table (ns rows,
// tiles of kThreads * kUnroll1 vectors). partials points at this group's
// first slot of field 0; field 1 lies `stride` floats further; the grid
// is what the card keeps resident at once (measured occupancy), at most
// max_grid (the slots the group has) and n_tiles.
int fused_pass1(const void* segs, int ns, long long n_tiles,
                const float* scale, float* partials, long long stride,
                int max_grid, int dtype, void* stream) {
  const Seg1* d = static_cast<const Seg1*>(segs);
  const bool write_u = scale != nullptr;
  if (dtype == 1)
    return write_u ? run_pass1<__nv_bfloat16, true>(d, ns, n_tiles, scale,
                                                   partials, stride,
                                                   max_grid, stream)
                   : run_pass1<__nv_bfloat16, false>(d, ns, n_tiles, scale,
                                                    partials, stride,
                                                    max_grid, stream);
  return write_u ? run_pass1<float, true>(d, ns, n_tiles, scale, partials,
                                          stride, max_grid, stream)
                 : run_pass1<float, false>(d, ns, n_tiles, scale, partials,
                                           stride, max_grid, stream);
}

// dtype: the params' and grads' (0 float32, 1 bfloat16); moment_dtype:
// the moments' (the same codes); rates: two float32 in device memory,
// the step's lr and Adam's bias-corrected lr_t (lr again otherwise)
int fused_pass2(const void* desc, int nb, long long n_tiles,
                const int* chunk_leaf, const int* flags, const float* lrs,
                const float* nw, long long chunk, const Pass2Args* args,
                const float* rates, const float* sumsq, const float* found,
                float* partials, long long stride, int grid, int dtype,
                int moment_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bucket* d = static_cast<const Bucket*>(desc);
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return moment_dtype == 1
               ? run_pass2<bf16, bf16>(d, nb, n_tiles, chunk_leaf, flags,
                                       lrs, nw, chunk, *args, rates, sumsq,
                                       found, partials, stride, grid, s)
               : run_pass2<bf16, float>(d, nb, n_tiles, chunk_leaf, flags,
                                        lrs, nw, chunk, *args, rates, sumsq,
                                        found, partials, stride, grid, s);
  return moment_dtype == 1
             ? run_pass2<float, bf16>(d, nb, n_tiles, chunk_leaf, flags, lrs,
                                      nw, chunk, *args, rates, sumsq, found,
                                      partials, stride, grid, s)
             : run_pass2<float, float>(d, nb, n_tiles, chunk_leaf, flags,
                                       lrs, nw, chunk, *args, rates, sumsq,
                                       found, partials, stride, grid, s);
}

int fused_finalize(const float* partials, long long n_slots, int n_fields,
                   int max_mask, int with_sqrt, float* out, void* stream) {
  fused_finalize_kernel<<<1, kFinalizeThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      partials, n_slots, n_fields, max_mask, with_sqrt, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
