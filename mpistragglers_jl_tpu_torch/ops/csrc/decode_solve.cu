// The coded-GEMM decode for Hopper (sm_90a): G_S X = S for the k source
// blocks X, from k f32 shards S where they lie, in one pass.
//
// Not the counterpart of a TPU kernel: the JAX package decodes with
// jax.scipy.linalg.solve (mpistragglers_jl_tpu/ops/coding.py `_decode`),
// which XLA lowers to an LU and two triangular solves. On the card the
// port ran that as a chain of library kernels (ops/coding.py `_lu_solve`:
// a k x k factor, an unpack, a row gather, two right-sided trsm, and the
// stack of the shards before them), 20x off the bound below. The k x k
// system is known on the host (the fresh set and the generator are host
// data), so ops/decode_solve.py factors G_S there, in float64 with
// partial pivoting (the algorithm of gesv), and this kernel does the
// rest.
//
// What it computes, for every element e of a shard (N elements each),
// with the shards' pointers already in pivot order (src[i] is the shard
// of row perm[i] of G_S), lu holding the unit-lower L below its
// diagonal and U on and above it, and dinv[i] = 1 / U[i][i]:
//   y_i = S_perm[i][e] - sum_{j < i} L[i][j] y_j            i = 0 .. k-1
//   x_i = (y_i - sum_{j > i} U[i][j] x_j) * dinv[i]         i = k-1 .. 0
//   out[i * N + e] = x_i
// each sum in increasing j for y and decreasing j for x, one fmaf a term.
// A factor of 1 or 0 changes nothing, so an identity G_S copies the bits.
//
// What bounds it: bytes. Each shard element is read once and each
// product element written once, 2 * k * rows * cols * 4 bytes in all
// (portbench/bounds.py `decode_bytes`): 537 MB at BASELINE config 3
// (k = 6, 1366 x 8192 shards), 0.160 ms at the H100's 3.35 TB/s; 2.15 GB
// at config 4 (k = 8, 2048 x 16384), 0.641 ms. The k^2 fmaf an element
// (0.40 and 2.15 G fmaf, 0.81 and 4.3 GFLOP) are 0.012 and 0.064 ms at
// the f32 rate (bench/kernel_bounds.py), far under the bytes.
//
// Design against that: one read and one write of every element and
// nothing in between (no stack, no gather, no transposed copy); the
// substitution in registers, k float4 a thread; 16-byte accesses with
// streaming cache hints (__ldcs, __stcs: nothing is read twice); the k
// pointers, L, U and dinv passed by value in the kernel's parameters, so
// no index or factor crosses to the card and each coefficient is an
// operand from the constant bank; a grid-stride loop with the blocks
// that fit on every SM at once. k is a template parameter (1..16), so
// the loops unroll and the k float4 stay in registers. Shards whose
// element count is not a multiple of 4, or whose rows of a fused stack
// are not 16-byte aligned (a shard of 3 x 3 elements), take the same
// kernel instantiated on float: the same arithmetic, 4-byte accesses.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;

struct Factors {
  const void* src[kMaxK];  // shard of row perm[i], in pivot order
  float lu[kMaxK * kMaxK];   // row-major, leading dimension kMaxK
  float dinv[kMaxK];
};

__device__ __forceinline__ void axpy(float4& y, float a, const float4& x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ void axpy(float& y, float a, const float& x) {
  y = fmaf(a, x, y);
}

__device__ __forceinline__ void scale(float4& x, float d) {
  x.x *= d;
  x.y *= d;
  x.z *= d;
  x.w *= d;
}

__device__ __forceinline__ void scale(float& x, float d) { x *= d; }

// V is float4 (16-byte accesses) or float (any shape and alignment);
// nv counts V in one shard
template <int K, typename V>
__global__ void __launch_bounds__(kThreads)
    decode_solve_kernel(const Factors f, V* __restrict__ out,
                        long long nv) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < nv; e += stride) {
    V x[K];
#pragma unroll
    for (int i = 0; i < K; ++i)
      x[i] = __ldcs(static_cast<const V*>(f.src[i]) + e);
#pragma unroll
    for (int i = 1; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) axpy(x[i], -f.lu[i * kMaxK + j], x[j]);
    }
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
#pragma unroll
      for (int j = K - 1; j > i; --j) axpy(x[i], -f.lu[i * kMaxK + j], x[j]);
      scale(x[i], f.dinv[i]);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) __stcs(out + i * nv + e, x[i]);
  }
}

template <int K, typename V>
int launch_as(const Factors& f, void* out, long long nv, int sms,
              cudaStream_t s) {
  static int per_sm = 0;  // resident blocks an SM; the same on every call
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_solve_kernel<K, V>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
  }
  const long long need = (nv + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(need < full ? need : full);
  decode_solve_kernel<K, V>
      <<<grid, kThreads, 0, s>>>(f, static_cast<V*>(out), nv);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const Factors& f, void* out, long long n, bool vec, int sms,
           cudaStream_t s) {
  return vec ? launch_as<K, float4>(f, out, n / 4, sms, s)
             : launch_as<K, float>(f, out, n, sms, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// k shards of n f32 elements each at src[0..k-1] (pivot order); lu (k x
// k, row-major, leading dimension k) and dinv (k) on the host; out (k * n
// f32); sms the card's SM count. vec asks for the float4 instance, which
// needs n a multiple of 4 and every pointer 16-byte aligned (else the
// call is refused); vec = 0 takes the float instance, which serves any
// shape. Launches on `stream`. Returns a cudaError_t code, 0 when the
// launch was taken (or there was nothing to do).
extern "C" int decode_solve(int k, const void* const* src, const float* lu,
                            const float* dinv, void* out, long long n,
                            int vec, int sms, void* stream) {
  if (k < 1 || k > kMaxK || n < 0 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (vec && (n % 4 || !aligned16(out)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Factors f = {};
  for (int i = 0; i < k; ++i) {
    if (vec && !aligned16(src[i]))
      return static_cast<int>(cudaErrorMisalignedAddress);
    f.src[i] = src[i];
    f.dinv[i] = dinv[i];
    for (int j = 0; j < k; ++j) f.lu[i * kMaxK + j] = lu[i * k + j];
  }
  const bool v = vec != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(f, out, n, v, sms, s);
    case 2: return launch<2>(f, out, n, v, sms, s);
    case 3: return launch<3>(f, out, n, v, sms, s);
    case 4: return launch<4>(f, out, n, v, sms, s);
    case 5: return launch<5>(f, out, n, v, sms, s);
    case 6: return launch<6>(f, out, n, v, sms, s);
    case 7: return launch<7>(f, out, n, v, sms, s);
    case 8: return launch<8>(f, out, n, v, sms, s);
    case 9: return launch<9>(f, out, n, v, sms, s);
    case 10: return launch<10>(f, out, n, v, sms, s);
    case 11: return launch<11>(f, out, n, v, sms, s);
    case 12: return launch<12>(f, out, n, v, sms, s);
    case 13: return launch<13>(f, out, n, v, sms, s);
    case 14: return launch<14>(f, out, n, v, sms, s);
    case 15: return launch<15>(f, out, n, v, sms, s);
    default: return launch<16>(f, out, n, v, sms, s);
  }
}

extern "C" const char* decode_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
