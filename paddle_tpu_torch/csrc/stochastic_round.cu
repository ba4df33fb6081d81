// Stochastic rounding of float32 to bfloat16 for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It computes what the reference's tree
// update does in `down()` (paddle_tpu/optimizer/optimizer.py
// `apply_gradients_tree`, with `_stochastic_rounding`), which XLA fuses
// into the update there: for each element i of a float32 tensor x, the
// 32 random bits of jax.random.bits(key, x.shape, uint32) at flat index
// i (threefry2x32, the partitionable layout: the hash of the count
// (i >> 32, i & 0xffffffff) under the key, the two output words xor-ed),
// then
//     y[i] = bfloat16((bits(x[i]) + (bits_i & 0xffff)) & 0xffff0000).
// The truncated float has no low bits left, so its conversion to bf16
// is exact. Plain C interface, loaded with ctypes by
// paddle_tpu_torch/ops/kernels/stochastic_round.py, whose twin
// (`stochastic_round_reference`) computes the same bits with
// ops/threefry.py's torch integer ops.
//
// Why a kernel: the twin is ~140 elementwise int64 kernels over the
// tensor; bench.py's GPT-1.3B optimizer (Momentum, bf16 state) rounds
// every parameter and every velocity each step. Here one thread hashes
// one element in registers: 4 bytes read, 2 written, ~100 32-bit
// integer operations. What bounds it: the bytes at 3.35 TB/s slightly
// above the integer operations at the CUDA cores' rate, so the design
// is one coalesced float load and one bf16 store a thread, a grid that
// strides over the tensor, and the 20 rounds unrolled with the
// rotations as funnel shifts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, of the count (x1, x2) under (k1, k2): the
// schedule of jax/_src/prng.py `threefry2x32` (ops/threefry.py)
__device__ __forceinline__ void threefry2x32(unsigned k1, unsigned k2,
                                             unsigned& x1, unsigned& x2) {
  const unsigned ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    stochastic_round_kernel(const float* __restrict__ x,
                            __nv_bfloat16* __restrict__ y, long long n,
                            const unsigned* __restrict__ key) {
  const unsigned k1 = key[0], k2 = key[1];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    unsigned c1 = static_cast<unsigned>(i >> 32);
    unsigned c2 = static_cast<unsigned>(i);
    threefry2x32(k1, k2, c1, c2);
    const unsigned r = (c1 ^ c2) & 0xFFFFu;
    const unsigned b = (__float_as_uint(x[i]) + r) & 0xFFFF0000u;
    y[i] = __float2bfloat16_rn(__uint_as_float(b));
  }
}

}  // namespace

extern "C" {

// x: n float32, y: n bfloat16 (device pointers); key: the key's two
// 32-bit words in device memory (a captured launch reads each replay's);
// the grid is what `sms` SMs keep resident, at most one thread an
// element. Returns the launch's cudaError_t.
int stochastic_round(const float* x, void* y, long long n,
                     const unsigned* key, int sms, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  long long grid = static_cast<long long>(sms) * kBlocksPerSm;
  const long long need = (n + kThreads - 1) / kThreads;
  if (grid > need) grid = need;
  stochastic_round_kernel<<<static_cast<int>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<__nv_bfloat16*>(y), n, key);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
