// Int8 KV-cache decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in mpistragglers_jl_tpu/ops/
// decode_attention.py (launched by `quantized_decode_attention`): one
// query token per row attends a (B, L, Hkv, D) int8 K/V cache with f32
// per-(row, position, head) scales, GQA group g = H / Hkv <= 8.
//   s = (q . k) * scale * k_s      p = softmax over the visible keys
//   o = sum p * v_s * v / max(l, 1e-20)
// Visibility is the reference's: positional (kpos <= pos, and
// pos - kpos < window when window > 0) or ring (slot s valid iff
// s <= pos or pos >= W). Both are one contiguous key range [lo, hi]
// per row, so the loop walks exactly that range: tiles wholly outside
// it (ring warm-up, the causal frontier, the window's lower edge) are
// never read.
//
// What bounds it: bytes. One launch at the serving shape (B=8,
// L=W=1024, Hkv=2, D=128, g=4) reads 4,194,304 B of int8 K/V, 131,072 B
// of scales and writes/reads 32 KB of q and out, about 4.36 MB, or
// 1.30 us at 3.35 TB/s; its 34 MFLOP are negligible beside that.
//
// Design (simple first; split-K and TMA are later work):
// * one block per (kv head h, row b): 8 warps, warp i carries the
//   online-softmax state (m, l, acc[D]) of q row i of the group, so
//   the TPU's sequential k-grid becomes a loop inside the block;
// * K/V tiles of 32 keys stream through shared memory, dequantised to
//   f32 once on the way in (int8 -> float in registers); the next
//   tile's 16-byte global loads are issued before the current tile is
//   computed, so one tile of latency hides behind the arithmetic;
// * scores: lane j of warp i computes q_i . k_j in f32 (K rows padded
//   by 4 floats, so the 16-byte shared reads are conflict-free), the
//   tile max and sum are warp shuffles; PV: lane j owns 4 columns per
//   128 and broadcasts p_j with a shuffle;
// * positions come from a device (B,) int32 vector: no host sync;
// * the kernel allocates nothing and runs on the caller's stream; the
//   C entry returns cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: warp i owns q row i
constexpr int kTile = 32;      // keys per tile: lane j owns key j
constexpr int kMaxGroup = 8;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sign-extend byte `i` of w
__device__ __forceinline__ float sbyte(int w, int i) {
  return (float)((int)((unsigned)w << (24 - 8 * i)) >> 24);
}

// 16 int8 values -> 16 floats at a 16-byte aligned shared address
__device__ __forceinline__ void stash_i8x16(float* dst, int4 r) {
  const int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    reinterpret_cast<float4*>(dst)[c] = make_float4(
        sbyte(w[c], 0), sbyte(w[c], 1), sbyte(w[c], 2), sbyte(w[c], 3));
  }
}

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_int8_kernel(const T* __restrict__ q,
                                 const int8_t* __restrict__ k,
                                 const int8_t* __restrict__ v,
                                 const float* __restrict__ ks,
                                 const float* __restrict__ vs,
                                 const int* __restrict__ pos,
                                 T* __restrict__ out, int L, int Hkv, int g,
                                 float scale, int window, int ring) {
  constexpr int D = DV * 128;
  constexpr int KS = D + 4;   // padded K row stride, in floats
  constexpr int CH = D / 16;  // 16-byte chunks per cache row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kMaxGroup][D]
  float* Ks = Qs + kMaxGroup * D;               // [kTile][KS]
  float* Vs = Ks + kTile * KS;                  // [kTile][D]
  float* Ss = Vs + kTile * D;                   // k_s[kTile], v_s[kTile]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hkv * g;

  // this row's visible key range
  const int p = pos[b];
  int lo = 0, hi;
  if (ring) {
    hi = p >= L ? L - 1 : p;
  } else {
    hi = p < L - 1 ? p : L - 1;
    if (window > 0 && p - window + 1 > 0) lo = p - window + 1;
  }
  const int n_tiles = hi >= lo ? (hi - lo) / kTile + 1 : 0;

  const T* qb = q + ((size_t)b * H + (size_t)h * g) * D;
  for (int e = tid; e < g * D; e += kThreads) Qs[e] = to_f32(qb[e]);

  const size_t row = (size_t)Hkv * D;  // bytes between cache positions
  const int8_t* kb = k + (size_t)b * L * row + (size_t)h * D;
  const int8_t* vb = v + (size_t)b * L * row + (size_t)h * D;
  const float* ksb = ks + (size_t)b * L * Hkv + h;
  const float* vsb = vs + (size_t)b * L * Hkv + h;

  int4 kr[DV], vr[DV];
  float sr = 0.f;
  // global -> registers for the tile starting at key `base`
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < DV; ++u) {
      const int c = tid + kThreads * u;
      const int r = c / CH, col = (c % CH) * 16;
      const int t = base + r;
      if (t <= hi) {
        kr[u] = *reinterpret_cast<const int4*>(kb + (size_t)t * row + col);
        vr[u] = *reinterpret_cast<const int4*>(vb + (size_t)t * row + col);
      } else {
        kr[u] = make_int4(0, 0, 0, 0);
        vr[u] = make_int4(0, 0, 0, 0);
      }
    }
    if (tid < 2 * kTile) {
      const int t = base + (tid & (kTile - 1));
      sr = t <= hi ? (tid < kTile ? ksb : vsb)[(size_t)t * Hkv] : 0.f;
    }
  };
  // registers -> shared, dequantised to f32
  auto stash = [&]() {
#pragma unroll
    for (int u = 0; u < DV; ++u) {
      const int c = tid + kThreads * u;
      const int r = c / CH, col = (c % CH) * 16;
      stash_i8x16(Ks + r * KS + col, kr[u]);
      stash_i8x16(Vs + r * D + col, vr[u]);
    }
    if (tid < 2 * kTile) Ss[tid] = sr;
  };

  float m = kNeg, l = 0.f;
  float acc[4 * DV];
#pragma unroll
  for (int c = 0; c < 4 * DV; ++c) acc[c] = 0.f;

  if (n_tiles > 0) fetch(lo);
  for (int it = 0; it < n_tiles; ++it) {
    const int base = lo + it * kTile;
    __syncthreads();  // Qs written / previous tile fully consumed
    stash();
    __syncthreads();
    if (it + 1 < n_tiles) fetch(base + kTile);  // in flight meanwhile
    if (warp < g) {
      const bool valid = base + lane <= hi;
      const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * KS);
      const float4* q4 = reinterpret_cast<const float4*>(Qs + warp * D);
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll 8
      for (int x = 0; x < D / 4; ++x) {
        const float4 a = q4[x], c = k4[x];
        d0 = fmaf(a.x, c.x, d0);
        d1 = fmaf(a.y, c.y, d1);
        d2 = fmaf(a.z, c.z, d2);
        d3 = fmaf(a.w, c.w, d3);
      }
      const float s = ((d0 + d1) + (d2 + d3)) * scale * Ss[lane];
      const float m_new = fmaxf(m, warp_max(valid ? s : kNeg));
      const float pj = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(pj);
      m = m_new;
      const float pv = pj * Ss[kTile + lane];
#pragma unroll
      for (int c = 0; c < 4 * DV; ++c) acc[c] *= corr;
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float pjj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
        for (int u = 0; u < DV; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + j * D + u * 128 + lane * 4);
          acc[4 * u + 0] = fmaf(pjj, vv.x, acc[4 * u + 0]);
          acc[4 * u + 1] = fmaf(pjj, vv.y, acc[4 * u + 1]);
          acc[4 * u + 2] = fmaf(pjj, vv.z, acc[4 * u + 2]);
          acc[4 * u + 3] = fmaf(pjj, vv.w, acc[4 * u + 3]);
        }
      }
    }
  }

  if (warp < g) {
    const float den = fmaxf(l, 1e-20f);
    T* ob = out + ((size_t)b * H + (size_t)h * g + warp) * D;
#pragma unroll
    for (int u = 0; u < DV; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        put(ob + u * 128 + lane * 4 + c, acc[4 * u + c] / den);
    }
  }
}

template <typename T, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* pos, void* out,
                   int B, int L, int Hkv, int g, float scale, int window,
                   int ring, cudaStream_t stream) {
  constexpr int D = DV * 128;
  const size_t smem =
      sizeof(float) * (kMaxGroup * D + kTile * (D + 4) + kTile * D + 2 * kTile);
  auto kern = decode_attention_int8_kernel<T, DV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<T*>(out), L, Hkv, g, scale, window, ring);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* pos,
                     void* out, int B, int L, int Hkv, int g, float scale,
                     int window, int ring, cudaStream_t st) {
  switch (D) {
    case 128:
      return launch<T, 1>(q, k, v, ks, vs, pos, out, B, L, Hkv, g, scale,
                          window, ring, st);
    case 256:
      return launch<T, 2>(q, k, v, ks, vs, pos, out, B, L, Hkv, g, scale,
                          window, ring, st);
    case 384:
      return launch<T, 3>(q, k, v, ks, vs, pos, out, B, L, Hkv, g, scale,
                          window, ring, st);
    case 512:
      return launch<T, 4>(q, k, v, ks, vs, pos, out, B, L, Hkv, g, scale,
                          window, ring, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, Hkv*g, D) f32 or bf16; k, v (B, L, Hkv, D) int8; ks, vs
// (B, L, Hkv) f32; pos (B,) int32; out like q. All contiguous, all on
// the current device. window <= 0 means no window. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int k5_decode_attention_int8(const void* q, const void* k,
                                        const void* v, const void* ks,
                                        const void* vs, const void* pos,
                                        void* out, int B, int L, int Hkv,
                                        int g, int D, float scale, int window,
                                        int ring, int is_bf16, void* stream) {
  if (g < 1 || g > kMaxGroup || B < 1 || L < 1 || Hkv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, ks, vs, pos, out, B, L,
                                        Hkv, g, scale, window, ring, st)
              : dispatch<float>(D, q, k, v, ks, vs, pos, out, B, L, Hkv, g,
                                scale, window, ring, st);
  return (int)e;
}

extern "C" const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
