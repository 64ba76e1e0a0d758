// Flash attention for Hopper (sm_90a): the forward and its three backward
// kernels.
//
// Replaces the four TPU kernels of mpistragglers_jl_tpu/ops/flash_attention.py:
//   K1 `_fwd_kernel`       -> flash_fwd_kernel       (o, lse)
//   K2 `_bwd_dq_kernel`    -> flash_bwd_dq_kernel    (dq)
//   K3 `_bwd_dkv_kernel`   -> flash_bwd_dkv_kernel   (dk, dv per q head)
//   K4 `_bwd_fused_kernel` -> flash_bwd_fused_kernel (dq + f32 dk, dv sums)
//
// Layouts as the reference's: q (BH, Lq, D), k and v (BH/g, Lk, D) with
// q row b reading kv row b / g (GQA; K and V are never repeated in
// memory), o and dq like q, lse and delta (BH, Lq) f32. Visibility of key
// kpos to query qpos: kpos <= qpos when causal, qpos - kpos < window when
// window > 0. A masked score is -1e30, never -inf: the backward's
// exp(s - lse) relies on it underflowing to 0, and the forward's
// exp(m_prev - m_new) never forms inf - inf.
//
// Precision as the reference's: every product (Q.K^T, P.V, dO.V^T, dS.K,
// P^T.dO, dS^T.Q) takes f32 operands (bf16 inputs are widened, exactly)
// and sums in f32; only the stored o, dq, dk and dv round to the input
// type. No product rounds P or dS to bf16, so these kernels run on the
// f32 FMA units, not the tensor cores.
//
// What bounds them: operations. One causal call at the training shape
// (B=8, L=2048, H=8, D=128) needs 68.8 GFLOP (K1) to 171.9 GFLOP (K4)
// over the visible (query, key) pairs, and moves 25-60 MB; at the H100's
// bf16 tensor-core peak that is 70-174 us, at its 67 TFLOP/s f32 FMA peak
// 1.0-2.6 ms, the floor of this design.
//
// Design (simple first; tensor cores, TMA and warp specialisation are
// later work):
// * one block of 256 threads per (BH row, 64-query tile) for K1, K2, K4,
//   and per (BH row, 64-key tile) for K3, looping over the other axis in
//   64-row tiles: the TPU's sequential inner grid axis becomes this loop;
// * a tile wholly outside the band (above the causal diagonal, or left of
//   the window) is skipped, the reference's `_block_run` at 64 x 64; the
//   tile's own rows and columns are masked as `_block_mask` does, and rows
//   or keys past Lq or Lk count as masked, so any L is taken;
// * tiles live in shared memory as f32, rows padded by one float so the
//   column reads of K, V, Q and dO are conflict-free; each thread owns a
//   4 x (D/16) or 4 x 4 register block of every product;
// * K4 adds each (query tile, key tile)'s dk and dv contributions into one
//   f32 (BH, Lk, D) sum per q head with atomics (zeroed by the caller), so
//   its partial memory does not grow with the number of query tiles; the
//   order of those additions varies from run to run;
// * the kernels allocate nothing and run on the caller's stream; the C
//   entries return cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kTile = 64;      // query and key rows per tile
constexpr int kSS = kTile + 1; // padded row stride of a score tile
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

struct Shape {
  int g, Lq, Lk;
  float scale;
  int causal, window;
};

// is key kp visible to query qp (both inside their lengths)?
__device__ __forceinline__ bool visible(int qp, int kp, const Shape& s) {
  return qp < s.Lq && kp < s.Lk && (!s.causal || kp <= qp) &&
         (s.window <= 0 || qp - kp < s.window);
}

// does the (query tile at q0, key tile at k0) pair hold a visible pair?
__device__ __forceinline__ bool tile_runs(int q0, int k0, const Shape& s) {
  if (s.causal && k0 > q0 + kTile - 1) return false;
  if (s.window > 0 && q0 - (k0 + kTile - 1) >= s.window) return false;
  return true;
}

// rows [r0, r0 + 64) of a (L, D) matrix -> f32 shared tile of row stride
// `stride`; rows past L are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int r0, int L) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * stride + c] =
        r0 + r < L ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// 64 per-row statistics (lse, delta) of rows [r0, r0 + 64); 0 past L
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int L) {
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    dst[threadIdx.x] = r < L ? src[r] : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over the 64 x 64
// tile pair, A and B of row stride D + 1
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int DS = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * DS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * DS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c S[row_i][c] * M[c][tx + 16 j], the score tile S
// (stride kSS) read by rows (row_i = ty + 16 i, TRANS = false) or by
// columns (S[c][ty + 16 i], TRANS = true); M of row stride `ms`
template <int D, bool TRANS>
__device__ __forceinline__ void score_times(float (&acc)[4][D / 16],
                                            const float* S, const float* M,
                                            int ms, int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < kTile; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = TRANS ? S[c * kSS + ty + 16 * i] : S[(ty + 16 * i) * kSS + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float m = M[c * ms + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], m, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- K1

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Shape sh) {
  constexpr int DS = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][DS]
  float* Ks = Qs + kTile * DS;    // [64][DS]
  float* Vs = Ks + kTile * DS;    // [64][D]
  float* Ss = Vs + kTile * D;     // [64][kSS] scores, then P
  float* Ms = Ss + kTile * kSS;   // running max per row
  float* Ls = Ms + kTile;         // running sum per row
  float* Cs = Ls + kTile;         // this tile's rescale per row

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t kv_off = (size_t)(bh / sh.g) * sh.Lk * D;

  load_tile<T, D>(Qs, DS, q + (size_t)bh * sh.Lq * D, q0, sh.Lq);
  if (tid < kTile) {
    Ms[tid] = kNeg;
    Ls[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (sh.Lk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_runs(q0, k0, sh)) continue;  // uniform over the block
    __syncthreads();  // Q and row state written; previous tile consumed
    load_tile<T, D>(Ks, DS, k + kv_off, k0, sh.Lk);
    load_tile<T, D>(Vs, D, v + kv_off, k0, sh.Lk);
    __syncthreads();
    float s[4][4] = {};
    dot_rows<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ss[r * kSS + c] =
            visible(q0 + r, k0 + c, sh) ? s[i][j] * sh.scale : kNeg;
      }
    __syncthreads();
    // online softmax: warp w owns rows 8w .. 8w + 7, lane j keys j, j + 32
    for (int rr = 0; rr < kTile / 8; ++rr) {
      const int r = warp * (kTile / 8) + rr;
      float* srow = Ss + r * kSS;
      const float x0 = srow[lane], x1 = srow[lane + 32];
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = visible(q0 + r, k0 + lane, sh) ? expf(x0 - m_new) : 0.f;
      const float p1 =
          visible(q0 + r, k0 + lane + 32, sh) ? expf(x1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Ls[r] = Ls[r] * corr + sum;
        Ms[r] = m_new;
        Cs[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = Cs[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    score_times<D, false>(acc, Ss, Vs, D, ty, tx);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qr = q0 + r;
    if (qr >= sh.Lq) continue;
    const float l = fmaxf(Ls[r], 1e-20f);
    T* orow = o + ((size_t)bh * sh.Lq + qr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) put(orow + tx + 16 * j, acc[i][j] / l);
    if (tx == 0) lse[(size_t)bh * sh.Lq + qr] = Ms[r] + logf(l);
  }
}

// ------------------------------------------------ shared backward step

// Scores and dP of one (query tile, key tile) pair, from Q, dO, K, V
// tiles (row stride D + 1) and the tile's lse and delta rows: writes
// P = exp(s - lse) (0 past Lq or Lk) into Ps when WRITE_P, and
// dS = P * (dP - delta) into Ds.
template <int D, bool WRITE_P>
__device__ __forceinline__ void probs_and_ds(
    float* Ps, float* Ds, const float* Qs, const float* Os, const float* Ks,
    const float* Vs, const float* LSEs, const float* DLs, int q0, int k0,
    const Shape& sh, int ty, int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  dot_rows<D>(s, Qs, Ks, ty, tx);
  dot_rows<D>(dp, Os, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int qp = q0 + r, kp = k0 + c;
      const float sv = visible(qp, kp, sh) ? s[i][j] * sh.scale : kNeg;
      const float p =
          qp < sh.Lq && kp < sh.Lk ? expf(sv - LSEs[r]) : 0.f;
      if (WRITE_P) Ps[r * kSS + c] = p;
      Ds[r * kSS + c] = p * (dp[i][j] - DLs[r]);
    }
}

// ---------------------------------------------------------------- K2

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Shape sh) {
  constexpr int DS = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][DS]
  float* Os = Qs + kTile * DS;    // [64][DS] dO
  float* Ks = Os + kTile * DS;    // [64][DS]
  float* Vs = Ks + kTile * DS;    // [64][DS]
  float* Ds = Vs + kTile * DS;    // [64][kSS] dS
  float* LSEs = Ds + kTile * kSS;
  float* DLs = LSEs + kTile;

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_off = (size_t)bh * sh.Lq * D;
  const size_t kv_off = (size_t)(bh / sh.g) * sh.Lk * D;

  load_tile<T, D>(Qs, DS, q + q_off, q0, sh.Lq);
  load_tile<T, D>(Os, DS, dout + q_off, q0, sh.Lq);
  load_rows(LSEs, lse + (size_t)bh * sh.Lq, q0, sh.Lq);
  load_rows(DLs, delta + (size_t)bh * sh.Lq, q0, sh.Lq);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (sh.Lk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_runs(q0, k0, sh)) continue;
    __syncthreads();
    load_tile<T, D>(Ks, DS, k + kv_off, k0, sh.Lk);
    load_tile<T, D>(Vs, DS, v + kv_off, k0, sh.Lk);
    __syncthreads();
    probs_and_ds<D, false>(nullptr, Ds, Qs, Os, Ks, Vs, LSEs, DLs, q0, k0,
                           sh, ty, tx);
    __syncthreads();
    score_times<D, false>(acc, Ds, Ks, DS, ty, tx);  // dq += dS K
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= sh.Lq) continue;
    T* row = dq + ((size_t)bh * sh.Lq + qr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) put(row + tx + 16 * j, acc[i][j] * sh.scale);
  }
}

// ---------------------------------------------------------------- K3

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dkq, T* __restrict__ dvq, Shape sh) {
  constexpr int DS = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // [64][DS]
  float* Vs = Ks + kTile * DS;    // [64][DS]
  float* Qs = Vs + kTile * DS;    // [64][DS]
  float* Os = Qs + kTile * DS;    // [64][DS] dO
  float* Ps = Os + kTile * DS;    // [64][kSS] P
  float* Ds = Ps + kTile * kSS;   // [64][kSS] dS
  float* LSEs = Ds + kTile * kSS;
  float* DLs = LSEs + kTile;

  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_off = (size_t)bh * sh.Lq * D;
  const size_t kv_off = (size_t)(bh / sh.g) * sh.Lk * D;

  load_tile<T, D>(Ks, DS, k + kv_off, k0, sh.Lk);
  load_tile<T, D>(Vs, DS, v + kv_off, k0, sh.Lk);
  // rows ty + 16 i are KEY rows here, columns tx + 16 j of D
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (sh.Lq + kTile - 1) / kTile;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    if (!tile_runs(q0, k0, sh)) continue;
    __syncthreads();
    load_tile<T, D>(Qs, DS, q + q_off, q0, sh.Lq);
    load_tile<T, D>(Os, DS, dout + q_off, q0, sh.Lq);
    load_rows(LSEs, lse + (size_t)bh * sh.Lq, q0, sh.Lq);
    load_rows(DLs, delta + (size_t)bh * sh.Lq, q0, sh.Lq);
    __syncthreads();
    probs_and_ds<D, true>(Ps, Ds, Qs, Os, Ks, Vs, LSEs, DLs, q0, k0, sh, ty,
                          tx);
    __syncthreads();
    score_times<D, true>(dv, Ps, Os, DS, ty, tx);  // dv += P^T dO
    score_times<D, true>(dk, Ds, Qs, DS, ty, tx);  // dk += dS^T Q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= sh.Lk) continue;
    const size_t row = ((size_t)bh * sh.Lk + kr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      put(dkq + row + tx + 16 * j, dk[i][j] * sh.scale);
      put(dvq + row + tx + 16 * j, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------- K4

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, float* __restrict__ dkp,
                           float* __restrict__ dvp, Shape sh) {
  constexpr int DS = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][DS]
  float* Os = Qs + kTile * DS;    // [64][DS] dO
  float* Ks = Os + kTile * DS;    // [64][DS]
  float* Vs = Ks + kTile * DS;    // [64][DS]
  float* Ps = Vs + kTile * DS;    // [64][kSS] P
  float* Ds = Ps + kTile * kSS;   // [64][kSS] dS
  float* LSEs = Ds + kTile * kSS;
  float* DLs = LSEs + kTile;

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_off = (size_t)bh * sh.Lq * D;
  const size_t kv_off = (size_t)(bh / sh.g) * sh.Lk * D;

  load_tile<T, D>(Qs, DS, q + q_off, q0, sh.Lq);
  load_tile<T, D>(Os, DS, dout + q_off, q0, sh.Lq);
  load_rows(LSEs, lse + (size_t)bh * sh.Lq, q0, sh.Lq);
  load_rows(DLs, delta + (size_t)bh * sh.Lq, q0, sh.Lq);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (sh.Lk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_runs(q0, k0, sh)) continue;
    __syncthreads();
    load_tile<T, D>(Ks, DS, k + kv_off, k0, sh.Lk);
    load_tile<T, D>(Vs, DS, v + kv_off, k0, sh.Lk);
    __syncthreads();
    probs_and_ds<D, true>(Ps, Ds, Qs, Os, Ks, Vs, LSEs, DLs, q0, k0, sh, ty,
                          tx);
    __syncthreads();
    score_times<D, false>(acc, Ds, Ks, DS, ty, tx);  // dq += dS K
    // this query tile's dv and dk contributions to key rows k0 + ty + 16 i
    float part[4][NJ];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) part[i][j] = 0.f;
      if (pass == 0)
        score_times<D, true>(part, Ps, Os, DS, ty, tx);  // P^T dO
      else
        score_times<D, true>(part, Ds, Qs, DS, ty, tx);  // dS^T Q
      float* dst = pass == 0 ? dvp : dkp;
      const float mul = pass == 0 ? 1.f : sh.scale;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = k0 + ty + 16 * i;
        if (kr >= sh.Lk) continue;
        float* row = dst + ((size_t)bh * sh.Lk + kr) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          atomicAdd(row + tx + 16 * j, part[i][j] * mul);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= sh.Lq) continue;
    T* row = dq + ((size_t)bh * sh.Lq + qr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) put(row + tx + 16 * j, acc[i][j] * sh.scale);
  }
}

// ------------------------------------------------------------ launching

enum Kernel { kFwd, kDq, kDkv, kFused };

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *out_lse, *d1, *d2, *d3;
  int BH;
  Shape sh;
  cudaStream_t stream;
};

template <int D>
size_t smem_bytes(Kernel which) {
  const size_t tile = (size_t)kTile * (D + 1), score = (size_t)kTile * kSS;
  switch (which) {
    case kFwd:
      return sizeof(float) * (2 * tile + kTile * D + score + 3 * kTile);
    case kDq:
      return sizeof(float) * (4 * tile + score + 2 * kTile);
    default:
      return sizeof(float) * (4 * tile + 2 * score + 2 * kTile);
  }
}

template <typename F>
cudaError_t prepare(F kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
cudaError_t launch(Kernel which, const Args& a) {
  const size_t smem = smem_bytes<D>(which);
  const int nq = (a.sh.Lq + kTile - 1) / kTile;
  const int nk = (a.sh.Lk + kTile - 1) / kTile;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t e;
  switch (which) {
    case kFwd: {
      auto kern = flash_fwd_kernel<T, D>;
      if ((e = prepare(kern, smem)) != cudaSuccess) return e;
      kern<<<dim3(nq, a.BH), kThreads, smem, a.stream>>>(
          q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.out_lse),
          a.sh);
      break;
    }
    case kDq: {
      auto kern = flash_bwd_dq_kernel<T, D>;
      if ((e = prepare(kern, smem)) != cudaSuccess) return e;
      kern<<<dim3(nq, a.BH), kThreads, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.d1), a.sh);
      break;
    }
    case kDkv: {
      auto kern = flash_bwd_dkv_kernel<T, D>;
      if ((e = prepare(kern, smem)) != cudaSuccess) return e;
      kern<<<dim3(nk, a.BH), kThreads, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.d1),
          static_cast<T*>(a.d2), a.sh);
      break;
    }
    case kFused: {
      auto kern = flash_bwd_fused_kernel<T, D>;
      if ((e = prepare(kern, smem)) != cudaSuccess) return e;
      kern<<<dim3(nq, a.BH), kThreads, smem, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.d1),
          static_cast<float*>(a.d2), static_cast<float*>(a.d3), a.sh);
      break;
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, Kernel which, const Args& a) {
  switch (D) {
    case 64:
      return launch<T, 64>(which, a);
    case 128:
      return launch<T, 128>(which, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Kernel which, int D, int is_bf16, const Args& a) {
  if (a.BH < 1 || a.sh.g < 1 || a.BH % a.sh.g != 0 || a.sh.Lq < 1 ||
      a.sh.Lk < 1 || a.BH > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(D, which, a)
                       : dispatch<float>(D, which, a));
}

Args make_args(int BH, int g, int Lq, int Lk, float scale, int causal,
               int window, void* stream) {
  Args a{};
  a.BH = BH;
  a.sh = Shape{g, Lq, Lk, scale, causal, window};
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// All tensors contiguous on the current device; q, k, v, do, o, dq, dk, dv
// of one type (f32 or bf16, is_bf16); lse, delta and K4's dk/dv sums f32.
// q (BH, Lq, D); k, v (BH/g, Lk, D); lse, delta (BH, Lq). window <= 0 means
// no window. Each returns the CUDA error code of its launch (0 on success).

// K1: o (BH, Lq, D), lse (BH, Lq).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int BH, int g, int Lq, int Lk, int D,
                         float scale, int causal, int window, int is_bf16,
                         void* stream) {
  Args a = make_args(BH, g, Lq, Lk, scale, causal, window, stream);
  a.q = q, a.k = k, a.v = v, a.o = o, a.out_lse = lse;
  return run(kFwd, D, is_bf16, a);
}

// K2: dq (BH, Lq, D).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int BH, int g,
                            int Lq, int Lk, int D, float scale, int causal,
                            int window, int is_bf16, void* stream) {
  Args a = make_args(BH, g, Lq, Lk, scale, causal, window, stream);
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.d1 = dq;
  return run(kDq, D, is_bf16, a);
}

// K3: dk, dv per q head, (BH, Lk, D) each.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dkq, void* dvq, int BH,
                             int g, int Lq, int Lk, int D, float scale,
                             int causal, int window, int is_bf16,
                             void* stream) {
  Args a = make_args(BH, g, Lq, Lk, scale, causal, window, stream);
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.d1 = dkq, a.d2 = dvq;
  return run(kDkv, D, is_bf16, a);
}

// K4: dq (BH, Lq, D); dk, dv per q head added into the ZEROED f32
// (BH, Lk, D) sums dkp, dvp.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dkp,
                               void* dvp, int BH, int g, int Lq, int Lk,
                               int D, float scale, int causal, int window,
                               int is_bf16, void* stream) {
  Args a = make_args(BH, g, Lq, Lk, scale, causal, window, stream);
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.d1 = dq, a.d2 = dkp, a.d3 = dvp;
  return run(kFused, D, is_bf16, a);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
