// Token sampling for Hopper (sm_90a): one fused pass over each row's
// logits that draws jax.random's Gumbel noise and picks the token.
//
// Not the counterpart of a TPU kernel: the reference samples with XLA
// ops that its compiler fuses (mpistragglers_jl_tpu/models/decode.py
// `_pick_token`, per row as in models/serving.py `_pick_rows`). Eager
// torch runs the same chain as ~150 small launches per decode step
// (ops/sampling.py `sample_rows_ref`, the plain version), so the port
// fuses it into this one kernel.
//
// What it computes, per row r of logits (R, V), with the row's key
// keys[r], position pos[r] and fold index rows[r]:
//   k   = fold_in(fold_in(keys[r], pos[r]), rows[r])    (Threefry-2x32)
//   b_j = x0 ^ x1 of threefry(k, (0, j))                 j = 0 .. V-1
//   u_j = max(tiny, ((b_j >> 9 | 0x3F800000) as f32 - 1) + tiny)
//   g_j = -log(-log(u_j))                                XLA's f32 log
//   l_j = logits[r, j] / temperature, -inf where below the row's k-th
//         largest (top_k; kth[r] from torch.topk, divided here)
//   out[r] = the first j maximising g_j + l_j
// Every f32 step is one correctly rounded operation in JAX's order
// (__fdiv_rn, __fadd_rn, __fmaf_rn where XLA's CPU code fuses a
// multiply-add), so the noise and the token equal the JAX package's bit
// for bit. The log is the Cephes polynomial XLA's CPU backend emits, not
// logf: ops/sampling.py's plain version computes the same one in torch
// and the tests hold it bit-equal to jax.random.gumbel over all 2^23
// inputs. Built without --use_fast_math.
//
// What bounds it: integer operations. Per entry Threefry takes 20
// rounds of add, rotate and xor plus 5 key injections (~80 int32 ops),
// the two logs ~44 f32 ops. At the serving shape (R=8, V=32768) that is
// 21 M int32 ops, 1.26 us at the H100's 16.7 TOP/s of int32 (64 lanes
// an SM a clock), against 0.52 MB of bf16 logits, 0.16 us at 3.35 TB/s
// (bench/kernel_bounds.py `sampling_bounds`).
//
// Design, first version: one block of 1024 threads per row. Thread 0
// folds the row's key into shared memory; every thread walks the
// vocabulary with a stride of 1024, keeping a running (value, first
// index) maximum, then a warp shuffle and one shared-memory pass reduce
// the block. Ties go to the smaller index and NaN ranks above every
// number, as argmax does. At R=8 only 8 of 132 SMs work: splitting a row
// over several blocks (a second pass, or a packed 64-bit atomic max) is
// the known next step. The kernel reads pos, keys and rows from device
// memory and never syncs, so a CUDA graph can capture it. Optional
// outputs write each entry's bits and noise (the tests hold them to the
// plain version).

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds: jax._src.prng._threefry2x32_lowering
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ float f32_bits(uint32_t b) {
  return __uint_as_float(b);
}

// XLA's CPU log on f32 (Cephes), for positive finite x: the constants
// are the f32 values XLA rounds its literals to, written as bits.
__device__ __forceinline__ float xla_log(float x) {
  x = fmaxf(x, f32_bits(0x00800000u));  // the least normal f32
  const uint32_t b = __float_as_uint(x);
  const int ex = static_cast<int>(b >> 23) - 0x7f;
  const float m = f32_bits((b & ~0x7f800000u) | 0x3f000000u);
  float e = __fadd_rn(1.0f, static_cast<float>(ex));
  const bool low = m < f32_bits(0x3f3504f3u);  // sqrt(1/2)
  float t = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(t, t);
  const float x3 = __fmul_rn(x2, t);
  float y = __fmaf_rn(t, f32_bits(0x3d9021bbu), f32_bits(0xbdebd1b8u));
  float y1 = __fmaf_rn(t, f32_bits(0xbdfe5d4fu), f32_bits(0x3e11e9bfu));
  float y2 = __fmaf_rn(t, f32_bits(0x3e4cceacu), f32_bits(0xbe7ffffcu));
  y = __fmaf_rn(y, t, f32_bits(0x3def251au));
  y1 = __fmaf_rn(y1, t, f32_bits(0xbe2aae50u));
  y2 = __fmaf_rn(y2, t, f32_bits(0x3eaaaaaau));
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(f32_bits(0xb95e8083u), e));  // q1 * e
  t = __fmaf_rn(-0.5f, x2, t);
  t = __fadd_rn(t, y);
  return __fmaf_rn(f32_bits(0x3f318000u), e, t);  // + q2 * e
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// argmax order: NaN above every number, then the larger value, then the
// smaller index
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  const bool vn = v != v, bn = bv != bv;
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return j < bj;
}

__device__ __forceinline__ void warp_best(float& bv, int& bj) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oj = __shfl_down_sync(0xffffffffu, bj, off);
    if (better(ov, oj, bv, bj)) {
      bv = ov;
      bj = oj;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sample_rows_kernel(const T* __restrict__ logits, long long ld, int V,
                       const T* __restrict__ kth, long long kth_ld,
                       const int* __restrict__ pos,
                       const long long* __restrict__ keys,
                       const int* __restrict__ rows, float temperature,
                       int* __restrict__ out, uint32_t* __restrict__ bits_out,
                       float* __restrict__ noise_out) {
  __shared__ uint32_t sk[2];
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int r = blockIdx.x;
  if (threadIdx.x == 0) {
    const uint2 kp = threefry(static_cast<uint32_t>(keys[2 * r]),
                              static_cast<uint32_t>(keys[2 * r + 1]), 0u,
                              static_cast<uint32_t>(pos[r]));
    const uint2 kr = threefry(kp.x, kp.y, 0u, static_cast<uint32_t>(rows[r]));
    sk[0] = kr.x;
    sk[1] = kr.y;
  }
  __syncthreads();
  const uint32_t k0 = sk[0], k1 = sk[1];
  const float tiny = f32_bits(0x00800000u);
  const float kth_s =
      kth != nullptr ? __fdiv_rn(to_f32(kth[r * kth_ld]), temperature)
                     : -INFINITY;
  const T* row = logits + r * ld;
  const long long o = static_cast<long long>(r) * V;
  float bv = -INFINITY;
  int bj = INT_MAX;
  for (int j = threadIdx.x; j < V; j += kThreads) {
    const uint2 y = threefry(k0, k1, 0u, static_cast<uint32_t>(j));
    const uint32_t b = y.x ^ y.y;
    const float u0 = __fsub_rn(f32_bits((b >> 9) | 0x3f800000u), 1.0f);
    // uniform(tiny, 1): u * (1 - tiny) + tiny, and 1 - tiny rounds to 1
    const float u = fmaxf(tiny, __fadd_rn(u0, tiny));
    const float g = -xla_log(-xla_log(u));
    float lg = __fdiv_rn(to_f32(row[j]), temperature);
    if (lg < kth_s) lg = -INFINITY;
    const float v = __fadd_rn(g, lg);
    if (better(v, j, bv, bj)) {
      bv = v;
      bj = j;
    }
    if (bits_out != nullptr) bits_out[o + j] = b;
    if (noise_out != nullptr) noise_out[o + j] = g;
  }
  warp_best(bv, bj);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bj;
  }
  __syncthreads();
  if (warp == 0) {
    bv = sv[lane];  // kThreads / 32 == 32 warps, one per lane
    bj = si[lane];
    warp_best(bv, bj);
    if (lane == 0) out[r] = bj;
  }
}

}  // namespace

// logits (R, V) f32 or bf16 with row stride ld; kth: null, or the k-th
// largest logit of row r at kth[r * kth_ld] (same type); pos, rows
// int32 (R,); keys int64 (R, 2) holding uint32; out int32 (R,);
// bits_out uint32 (R, V) and noise_out f32 (R, V) optional (null).
// Returns a cudaError_t code, 0 when the launch was taken.
extern "C" int sample_rows(const void* logits, long long ld, int R, int V,
                           int is_bf16, const void* kth, long long kth_ld,
                           const void* pos, const void* keys,
                           const void* rows, float temperature, void* out,
                           void* bits_out, void* noise_out, void* stream) {
  if (R < 1 || V < 1 || !(temperature > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int*>(pos);
  const auto* k = static_cast<const long long*>(keys);
  const auto* w = static_cast<const int*>(rows);
  auto* o = static_cast<int*>(out);
  auto* bo = static_cast<uint32_t*>(bits_out);
  auto* no = static_cast<float*>(noise_out);
  if (is_bf16) {
    sample_rows_kernel<__nv_bfloat16><<<R, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), ld, V,
        static_cast<const __nv_bfloat16*>(kth), kth_ld, p, k, w, temperature,
        o, bo, no);
  } else {
    sample_rows_kernel<float><<<R, kThreads, 0, s>>>(
        static_cast<const float*>(logits), ld, V,
        static_cast<const float*>(kth), kth_ld, p, k, w, temperature, o, bo,
        no);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sampling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
