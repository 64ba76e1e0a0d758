// Flash attention for Hopper (sm_90a): the forward and its three backward
// kernels.
//
// Replaces the four TPU kernels of mpistragglers_jl_tpu/ops/flash_attention.py:
//   K1 `_fwd_kernel`       -> tc::flash_fwd_wgmma_kernel (bf16, wgmma)
//                             and flash_fwd_kernel (f32) (o, lse)
//   K2 `_bwd_dq_kernel`    -> tc::flash_bwd_dq_wgmma_kernel (bf16, wgmma)
//                             and flash_bwd_dq_kernel (f32) (dq)
//   K3 `_bwd_dkv_kernel`   -> tc::flash_bwd_dkv_wgmma_kernel (bf16, wgmma)
//                             and flash_bwd_dkv_kernel (f32) (dk, dv per q
//                             head)
//   K4 `_bwd_fused_kernel` -> tc::flash_bwd_fused_wgmma_kernel (bf16,
//                             wgmma) and flash_bwd_fused_kernel (f32)
//                             (dq, and dk, dv summed over the GQA group)
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
// type. The bf16 kernels of K1-K4 get that precision on the tensor cores
// (K1's note below): Q.K^T and dO.V^T are exact bf16 products, and every
// product that takes P or dS as an operand runs on P's or dS's two bf16
// halves, hi and lo. The f32 kernels round neither P nor dS to bf16 and
// run on the f32 FMA units.
//
// What bounds them: operations. One causal call at the training shape
// (B=8, L=2048, H=8, D=128) needs 68.8 GFLOP (K1) to 171.9 GFLOP (K4)
// over the visible (query, key) pairs, and moves 25-60 MB; at the H100's
// bf16 tensor-core peak that is 70-174 us, at its 67 TFLOP/s f32 FMA peak
// 1.0-2.6 ms, the floor of the FMA kernels. The hi/lo halves make the
// bf16 kernels issue more tensor work than the function needs: 1.5x for
// K1 (104 us), 4/3 for K2 (139 us), 1.5x for K3 (209 us), 1.6x for K4
// (278 us). On an H100 80GB HBM3 at 700 W, at that shape (chip_smoke.py
// phase 16, bench/flash_bwd_ab.py): K1 281-295 us, K2 323-357 us, K3
// 482-491 us, K4 854-872 us; the FMA kernels of K2, K3 and K4 took
// 5956, 6986 and 9004-9102 us.
//
// Design of the FMA kernels (the f32 routes):
// * one block of 256 threads per (BH row, 64-query tile) for K1 and K2,
//   per (BH row, 64-key tile) for K3 and per (kv row, 64-key tile) for
//   K4, looping over the other axis in 64-row tiles: the TPU's
//   sequential inner grid axis becomes this loop;
// * a tile wholly outside the band (above the causal diagonal, or left of
//   the window) is skipped, the reference's `_block_run` at 64 x 64; the
//   tile's own rows and columns are masked as `_block_mask` does, and rows
//   or keys past Lq or Lk count as masked, so any L is taken;
// * tiles live in shared memory as f32, rows padded by one float so the
//   column reads of K, V, Q and dO are conflict-free; each thread owns a
//   4 x (D/16) or 4 x 4 register block of every product;
// * K4 (both routes) is key-major: a block holds its key tile's dk and
//   dv across the g q heads of its kv head and their query tiles, so the
//   GQA group sum happens in registers and dk, dv are written once; each
//   (query tile, key tile)'s dq contribution dS.K is added into an f32
//   (BH, Lq, D) sum with atomics (zeroed by the caller), which a small
//   pass scales and casts to dq; the order of those additions varies from
//   run to run;
// * the kernels allocate nothing and run on the caller's stream; the C
//   entries return cudaGetLastError() for the wrapper to check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kTile = 64;      // query and key rows per tile
constexpr int kSS = kTile + 1; // padded row stride of a score tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
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

// ------------------------------------------- K1, bf16, tensor cores
//
// The bf16 forward runs on Hopper's warpgroup MMA (wgmma, bf16 operands,
// f32 accumulators), with the reference's precision:
// * S = Q.K^T: bf16 x bf16 products are exact in f32, as the
//   reference's bf16 dot with an f32 result is; only the order of the
//   f32 sums differs.
// * O += P.V: the reference takes P in f32, and P rounded to bf16
//   alone misses the f32 tolerance. P is split into hi = bf16(P) and
//   lo = bf16(P - hi), |P - hi - lo| <= 2^-17 P, and both go through
//   the tensor cores against the exact bf16 V. Row max, row sum (from
//   the f32 P), the rescale and the final division stay f32.
// Masking is -1e30 with p = 0 and the skipped tiles are `tile_runs`'s,
// as in the f32 kernel, so every L, causal or window, GQA and D in
// {64, 128} are taken.
//
// Design:
// * one block of one warpgroup (4 warps) per (BH row, 64-query tile);
//   warp w owns query rows 16w .. 16w + 15 of every accumulator. Query
//   tiles are issued longest-first (blockIdx.y counts down from the last
//   tile), so the causal tail of short tiles fills the card's last wave;
// * Q, K and V tiles are bf16 in shared memory as 64-column panels of
//   128-byte rows, 16-byte pieces XOR-swizzled by (row mod 8): the
//   128-byte swizzle the wgmma descriptors name, so the tensor cores read
//   Q and K (K-major) and V (MN-major) straight from shared memory, and
//   no ldmatrix runs; 16-byte cp.async loads; K double-buffered, V in
//   one buffer refilled once the tile's P.V is done, so a block needs
//   65 KB at D = 128 and, at 168 registers, three blocks fit an SM
//   (286 us at the train shape on an H100 80GB HBM3 at 700 W, against
//   311 us for two blocks with V double-buffered);
// * S = Q.K^T is m64n64k16 from shared memory; O += P.V is m64nDk16 with
//   P's hi and lo halves as register A fragments built from the score
//   accumulators (no shared-memory round trip);
// * per key tile: Q.K^T, wait, softmax, P.V, wait, while the next K
//   tile loads (the next V loads between the end of P.V and the next
//   tile's start); the three blocks on an SM overlap one's softmax and
//   loads with the others' products.
// What bounds it: operations, 68.8 GFLOP at the train shape (B=8,
// L=2048, H=8, D=128, causal), 69.5 us at 989 TFLOP/s; the hi/lo split
// issues the P.V half twice, 1.5x the reference's tensor-core work
// (104 us). Issuing tile t's Q.K^T beside tile t-1's P.V (so the
// softmax overlaps P.V within the warpgroup) made ptxas serialise the
// wgmmas and ran slower; that, TMA loads from a producer warp and two
// consumer warpgroups per block (128-query tiles) are left for later.

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);  // x in the low half
  return *reinterpret_cast<unsigned*>(&h);
}

// shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading byte offset (between 64-column panels of an MN-major operand;
// unused K-major), stride byte offset (between 8-row groups)
__device__ __forceinline__ unsigned long long gmma_desc(unsigned addr,
                                                        unsigned lbo,
                                                        unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16) |
         ((unsigned long long)((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of the generic proxy (cp.async) made visible to
// the tensor cores' async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// s (+)= Q.K^T over k16, m64n64, both operands from shared memory
__device__ __forceinline__ void wg_qk(float (&s)[8][4],
                                      unsigned long long da,
                                      unsigned long long db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(s[0][0]), "+f"(s[0][1]), "+f"(s[0][2]), "+f"(s[0][3]),
        "+f"(s[1][0]), "+f"(s[1][1]), "+f"(s[1][2]), "+f"(s[1][3]),
        "+f"(s[2][0]), "+f"(s[2][1]), "+f"(s[2][2]), "+f"(s[2][3]),
        "+f"(s[3][0]), "+f"(s[3][1]), "+f"(s[3][2]), "+f"(s[3][3]),
        "+f"(s[4][0]), "+f"(s[4][1]), "+f"(s[4][2]), "+f"(s[4][3]),
        "+f"(s[5][0]), "+f"(s[5][1]), "+f"(s[5][2]), "+f"(s[5][3]),
        "+f"(s[6][0]), "+f"(s[6][1]), "+f"(s[6][2]), "+f"(s[6][3]),
        "+f"(s[7][0]), "+f"(s[7][1]), "+f"(s[7][2]), "+f"(s[7][3])
      : "l"(da), "l"(db), "r"(acc));
}

// o += P.V over k16, m64n64 (D = 64) or m64n128 (D = 128), P from
// registers, V MN-major from shared memory
template <int D>
__device__ __forceinline__ void wg_pv(float (&o)[D / 8][4],
                                      const unsigned (&a)[4],
                                      unsigned long long db);

template <>
__device__ __forceinline__ void wg_pv<64>(float (&o)[8][4],
                                          const unsigned (&a)[4],
                                          unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      " {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),
        "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),
        "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),
        "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
        "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),
        "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),
        "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),
        "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wg_pv<128>(float (&o)[16][4],
                                           const unsigned (&a)[4],
                                           unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      " {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),
        "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),
        "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),
        "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
        "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),
        "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),
        "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),
        "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3]),
        "+f"(o[8][0]), "+f"(o[8][1]), "+f"(o[8][2]), "+f"(o[8][3]),
        "+f"(o[9][0]), "+f"(o[9][1]), "+f"(o[9][2]), "+f"(o[9][3]),
        "+f"(o[10][0]), "+f"(o[10][1]), "+f"(o[10][2]), "+f"(o[10][3]),
        "+f"(o[11][0]), "+f"(o[11][1]), "+f"(o[11][2]), "+f"(o[11][3]),
        "+f"(o[12][0]), "+f"(o[12][1]), "+f"(o[12][2]), "+f"(o[12][3]),
        "+f"(o[13][0]), "+f"(o[13][1]), "+f"(o[13][2]), "+f"(o[13][3]),
        "+f"(o[14][0]), "+f"(o[14][1]), "+f"(o[14][2]), "+f"(o[14][3]),
        "+f"(o[15][0]), "+f"(o[15][1]), "+f"(o[15][2]), "+f"(o[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// byte offset of element (r, c) in a tile of rows of D bf16 held as
// 64-column panels of 128-byte rows (panel = 64 rows x 128 B), 16-byte
// pieces swizzled by (r mod 8): the descriptors' 128-byte swizzle
__device__ __forceinline__ int pan(int r, int c) {
  return (c >> 6) * (kTile * 128) + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

template <int D>
__device__ __forceinline__ void load_panels(char* dst,
                                            const __nv_bfloat16* src, int r0,
                                            int L) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int u = 0; u < kTile * CPR / kThreads; ++u) {
    const int p = threadIdx.x + kThreads * u;
    const int r = p / CPR, c = (p % CPR) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + pan(r, c), ok ? src + (size_t)(r0 + r) * D + c : src,
               ok ? 16 : 0);
  }
}

constexpr unsigned kPanel = kTile * 128;  // bytes of one 64-column panel

// the first 1024-byte boundary in dynamic shared memory: the swizzle is
// of address bits, so every tile starts on one
__device__ __forceinline__ char* aligned_base(float4* smem) {
  return reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~(uintptr_t)1023);
}

// the key tiles [lo, hi] of the band that query tile q0 sees: the tiles
// `tile_runs` keeps, from the causal diagonal and the window
__device__ __forceinline__ void band_key_tiles(int q0, const Shape& sh,
                                               int& lo, int& hi) {
  hi = (sh.Lk + kTile - 1) / kTile - 1;
  lo = 0;
  if (sh.causal) hi = min(hi, (q0 + kTile - 1) / kTile);
  if (sh.window > 0) lo = max(0, (q0 - sh.window + 1) / kTile);
}

// is every (query, key) pair of the tile pair visible and inside the
// lengths? Then no element needs its mask.
__device__ __forceinline__ bool tile_full(int q0, int k0, const Shape& sh) {
  return q0 + kTile <= sh.Lq && k0 + kTile <= sh.Lk &&
         (!sh.causal || k0 + kTile - 1 <= q0) &&
         (sh.window <= 0 || q0 + kTile - 1 - k0 < sh.window);
}

// P = exp(scale s - lse) of query qp and key kp, as `probs_and_ds` forms
// it: the score masked to -1e30, and 0 past Lq or Lk
__device__ __forceinline__ float prob(float s, int qp, int kp, float lse,
                                      bool full, const Shape& sh) {
  float x = s * sh.scale;
  if (full) return expf(x - lse);
  if (!visible(qp, kp, sh)) x = kNeg;
  return qp < sh.Lq && kp < sh.Lk ? expf(x - lse) : 0.f;
}

// s = A.B^T over D, m64n64: A and B 64-row tiles in panels (K-major),
// issued into the open wgmma group
template <int D>
__device__ __forceinline__ void wg_rows(float (&s)[8][4], unsigned a,
                                        unsigned b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const unsigned off = (kk >> 2) * kPanel + (kk & 3) * 32;
    wg_qk(s, gmma_desc(a + off, 16, 1024), gmma_desc(b + off, 16, 1024),
          kk > 0);
  }
}

// a 64 x 64 accumulator x (rows gr, gr + 8 of each warp; x[j] holds
// columns 8j + 2tq, + 1) as register A fragments of its four k16 steps,
// split into hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_frags(const float (&x)[8][4],
                                            unsigned (&hi)[4][4],
                                            unsigned (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // a0: row gr, columns 2tq; a1: row gr+8; a2, a3: columns 8 + 2tq
      const float x0 = x[2 * kk + (r >> 1)][2 * (r & 1)];
      const float x1 = x[2 * kk + (r >> 1)][2 * (r & 1) + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<unsigned*>(&h);
      lo[kk][r] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// acc += (hi + lo).B over 64 rows of k: B a 64-row tile in panels read
// MN-major, each k16 step issued for hi, then lo
template <int D>
__device__ __forceinline__ void wg_hi_lo(float (&acc)[D / 8][4],
                                         const unsigned (&hi)[4][4],
                                         const unsigned (&lo)[4][4],
                                         unsigned b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned long long db = gmma_desc(b + kk * 2048, kPanel, 1024);
    wg_pv<D>(acc, hi[kk], db);
    wg_pv<D>(acc, lo[kk], db);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
    flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, Shape sh) {
  constexpr int TB = kTile * D * 2;  // bytes of one tile
  constexpr int NT = kTile / 8;
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  char* Qs = aligned_base(smem4);
  char* Ks = Qs + TB;      // [2 stages]
  char* Vs = Ks + 2 * TB;  // one stage: refilled once P.V is done

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kTile;  // longest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* kb = k + (size_t)(bh / sh.g) * sh.Lk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / sh.g) * sh.Lk * D;

  int kt_lo, kt_hi;
  band_key_tiles(q0, sh, kt_lo, kt_hi);

  load_panels<D>(Qs, q + (size_t)bh * sh.Lq * D, q0, sh.Lq);
  if (kt_lo <= kt_hi) {
    load_panels<D>(Ks, kb, kt_lo * kTile, sh.Lk);
    load_panels<D>(Vs, vb, kt_lo * kTile, sh.Lk);
  }
  cp_async_commit();

  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};  // rows gr, gr + 8
  const int qr0 = q0 + 16 * warp + gr;
  const unsigned qa = smem_u32(Qs);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi)
      load_panels<D>(Ks + (stage ^ 1) * TB, kb, (kt + 1) * kTile, sh.Lk);
    cp_async_commit();  // possibly empty: one group per tile
    cp_async_wait<1>();  // this tile's K and V have landed
    fence_async_smem();
    __syncthreads();
    const int k0 = kt * kTile;
    const unsigned ka = smem_u32(Ks + stage * TB);
    const unsigned va = smem_u32(Vs);
    // S = Q K^T: s[j] holds keys 8j + 2tq (+1) of rows gr, gr + 8
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wg_fence();
    wg_rows<D>(s, qa, ka);
    wg_commit();
    wg_wait0();
    // scale, mask, online softmax over the quad that shares a row
    const bool full = tile_full(q0, k0, sh);
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = qr0 + 8 * hr;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * hr + e] * sh.scale;
          if (!full && !visible(qp, k0 + 8 * j + 2 * tq + e, sh)) x = kNeg;
          s[j][2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * hr + e];
          const float p = (full || x > kNeg) ? expf(x - m_new) : 0.f;
          s[j][2 * hr + e] = p;
          sum += p;
        }
      corr[hr] = expf(m_r[hr] - m_new);
      l_r[hr] = l_r[hr] * corr[hr] + sum;  // this thread's share
      m_r[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }
    // O += P V, P = hi + lo as register A fragments
    unsigned ph[4][4], plo[4][4];
    split_frags(s, ph, plo);
    wg_fence();
    wg_hi_lo<D>(oacc, ph, plo, va);
    wg_commit();
    wg_wait0();
    __syncthreads();  // every warp is done with this K stage and V
    if (kt < kt_hi) load_panels<D>(Vs, vb, (kt + 1) * kTile, sh.Lk);
    cp_async_commit();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-20f);
    const int qp = qr0 + 8 * hr;
    if (qp < sh.Lq) {
      __nv_bfloat16* orow = o + ((size_t)bh * sh.Lq + qp) * D;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(oacc[j][2 * hr] / l,
                                  oacc[j][2 * hr + 1] / l);
      if (tq == 0) lse[(size_t)bh * sh.Lq + qp] = m_r[hr] + logf(l);
    }
  }
}

// ------------------------------------------- K2, bf16, tensor cores
//
// dq = scale . sum_keys dS . K, the reference's precision as in K1: S =
// Q.K^T and dP = dO.V^T from exact bf16 products summed in f32; P =
// exp(scale S - lse) (0 where masked or past Lq, Lk), dS = P (dP - delta)
// in f32; dS.K with dS split into bf16 hi + lo. One warpgroup per (BH
// row, 64-query tile), query tiles longest first; Q and dO stay in shared
// memory as A operands; K and V stream through two cp.async stages. Each
// K tile is B twice: K-major for S, MN-major for dq += dS.K (as K1's V).
// Per key tile: S and dP in one wgmma group, wait; P and dS in the
// accumulators' layout; dS's hi and lo as register fragments; dS.K,
// wait. Rows gr, gr + 8 of each warp keep their lse and delta in
// registers. What bounds it: operations, 103.1 GFLOP at the train shape
// (B=8, L=2048, H=8, D=128, causal), 104 us at 989 TFLOP/s; the hi/lo
// split issues dS.K twice, 4/3 of that (139 us). At D = 128 it holds 224
// registers and 97 KB of shared memory, two blocks an SM, which overlap
// one's exponentials and loads with the other's products: 323-357 us at
// the train shape on an H100 80GB HBM3 at 700 W (the FMA kernel: 5956
// us).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, Shape sh) {
  constexpr int TB = kTile * D * 2;
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  char* Qs = aligned_base(smem4);
  char* Os = Qs + TB;      // dO
  char* Ks = Os + TB;      // [2 stages]
  char* Vs = Ks + 2 * TB;  // [2 stages]

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kTile;  // longest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const size_t q_off = (size_t)bh * sh.Lq * D;
  const __nv_bfloat16* kb = k + (size_t)(bh / sh.g) * sh.Lk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / sh.g) * sh.Lk * D;

  int kt_lo, kt_hi;
  band_key_tiles(q0, sh, kt_lo, kt_hi);

  load_panels<D>(Qs, q + q_off, q0, sh.Lq);
  load_panels<D>(Os, dout + q_off, q0, sh.Lq);
  if (kt_lo <= kt_hi) {
    load_panels<D>(Ks, kb, kt_lo * kTile, sh.Lk);
    load_panels<D>(Vs, vb, kt_lo * kTile, sh.Lk);
  }
  cp_async_commit();

  const int qr0 = q0 + 16 * warp + gr;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = qr0 + 8 * hr;
    const bool in = qp < sh.Lq;
    lse_r[hr] = in ? lse[(size_t)bh * sh.Lq + qp] : 0.f;
    dl_r[hr] = in ? delta[(size_t)bh * sh.Lq + qp] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const unsigned qa = smem_u32(Qs), oa = smem_u32(Os);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt < kt_hi) {
      load_panels<D>(Ks + (stage ^ 1) * TB, kb, (kt + 1) * kTile, sh.Lk);
      load_panels<D>(Vs + (stage ^ 1) * TB, vb, (kt + 1) * kTile, sh.Lk);
    }
    cp_async_commit();  // possibly empty: one group per tile
    cp_async_wait<1>();  // this tile's K and V have landed
    fence_async_smem();
    __syncthreads();
    const int k0 = kt * kTile;
    const unsigned ka = smem_u32(Ks + stage * TB);
    const unsigned va = smem_u32(Vs + stage * TB);
    // s[j], dp[j]: keys 8j + 2tq (+1) of rows gr, gr + 8
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    wg_fence();
    wg_rows<D>(s, qa, ka);   // S = Q K^T
    wg_rows<D>(dp, oa, va);  // dP = dO V^T
    wg_commit();
    wg_wait0();
    const bool full = tile_full(q0, k0, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1;
        const float p = prob(s[j][i], qr0 + 8 * hr,
                             k0 + 8 * j + 2 * tq + (i & 1), lse_r[hr], full,
                             sh);
        s[j][i] = p * (dp[j][i] - dl_r[hr]);  // dS
      }
    unsigned dh[4][4], dlo[4][4];
    split_frags(s, dh, dlo);
    wg_fence();
    wg_hi_lo<D>(acc, dh, dlo, ka);  // dq += dS K
    wg_commit();
    wg_wait0();
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = qr0 + 8 * hr;
    if (qp >= sh.Lq) continue;
    __nv_bfloat16* row = dq + ((size_t)bh * sh.Lq + qp) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * hr] * sh.scale,
                                acc[j][2 * hr + 1] * sh.scale);
  }
}

// ------------------------------------------- K3, bf16, tensor cores
//
// dv = sum_queries P^T . dO and dk = scale . sum_queries dS^T . Q per q
// head, with K2's precision, transposed: one warpgroup per (BH row,
// 64-key tile), key tile 0 first (under causal it sees the most query
// tiles); K and V stay in shared memory as A operands; Q, dO and the
// query tile's lse and delta stream through two cp.async stages. Each Q
// and dO tile is B twice: K-major for S^T = K.Q^T and dP^T = V.dO^T,
// MN-major for dk += dS^T.Q and dv += P^T.dO. The accumulators hold key
// rows, so lse and delta are read by column from shared memory. The query
// tiles run from the band: from the key tile's own under causal, up to
// the last within the window. Per query tile: S^T and dP^T in one wgmma
// group, wait; P^T and dS^T in the accumulators' layout, each as hi and
// lo fragments; dv's and dk's products in one group, wait. What bounds
// it: operations, 137.5 GFLOP at the train shape, 139 us at 989
// TFLOP/s; the hi/lo split issues both products that take P or dS twice,
// 1.5x (209 us). At D = 128, dk and dv hold 128 f32 accumulators a
// thread and S^T and dP^T 64 more, which turn into the four fragment
// sets as they are read: 255 registers and a 4-byte spill, 98 KB of
// shared memory, two blocks an SM: 482-491 us at the train shape on an
// H100 80GB HBM3 at 700 W (the FMA kernel: 6986 us). The same kernel
// with tile_full() and prob() written out held no spill and took 524-537
// us in the same call (bench/flash_bwd_ab.py).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dkq,
                               __nv_bfloat16* __restrict__ dvq, Shape sh) {
  constexpr int TB = kTile * D * 2;
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  char* Ks = aligned_base(smem4);
  char* Vs = Ks + TB;
  char* Qs = Vs + TB;      // [2 stages]
  char* Os = Qs + 2 * TB;  // [2 stages] dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * TB);  // [2 stages][64] lse
  float* Dl = Ls + 2 * kTile;                         // [2 stages][64] delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const size_t kv_off = (size_t)(bh / sh.g) * sh.Lk * D;
  const __nv_bfloat16* qb = q + (size_t)bh * sh.Lq * D;
  const __nv_bfloat16* ob = dout + (size_t)bh * sh.Lq * D;
  // threads 0-63 copy lse, 64-127 delta: one float each per query tile
  const float* stat = (tid < kTile ? lse : delta) + (size_t)bh * sh.Lq;
  float* stat_s = (tid < kTile ? Ls : Dl) + (tid & (kTile - 1));

  const int nq = (sh.Lq + kTile - 1) / kTile;
  int qt_lo = 0, qt_hi = nq - 1;
  if (sh.causal) qt_lo = blockIdx.y;
  if (sh.window > 0)
    qt_hi = min(qt_hi, (k0 + kTile - 2 + sh.window) / kTile);

  auto load_query_tile = [&](int st, int qt) {
    const int q0 = qt * kTile;
    load_panels<D>(Qs + st * TB, qb, q0, sh.Lq);
    load_panels<D>(Os + st * TB, ob, q0, sh.Lq);
    const int r = q0 + (tid & (kTile - 1));
    const bool ok = r < sh.Lq;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(stat_s + st * kTile)),
                 "l"(ok ? stat + r : stat), "r"(ok ? 4 : 0));
  };

  load_panels<D>(Ks, k + kv_off, k0, sh.Lk);
  load_panels<D>(Vs, v + kv_off, k0, sh.Lk);
  if (qt_lo <= qt_hi) load_query_tile(0, qt_lo);
  cp_async_commit();

  const int kr0 = k0 + 16 * warp + gr;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const unsigned ka = smem_u32(Ks), va = smem_u32(Vs);

  for (int qt = qt_lo; qt <= qt_hi; ++qt) {
    const int stage = (qt - qt_lo) & 1;
    if (qt < qt_hi) load_query_tile(stage ^ 1, qt + 1);
    cp_async_commit();  // possibly empty: one group per tile
    cp_async_wait<1>();  // this tile's Q, dO, lse and delta have landed
    fence_async_smem();
    __syncthreads();
    const int q0 = qt * kTile;
    const unsigned qa = smem_u32(Qs + stage * TB);
    const unsigned oa = smem_u32(Os + stage * TB);
    const float* lse_s = Ls + stage * kTile;
    const float* dl_s = Dl + stage * kTile;
    // st[j], dpt[j]: queries 8j + 2tq (+1) of key rows gr, gr + 8
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    wg_fence();
    wg_rows<D>(st, ka, qa);   // S^T = K Q^T
    wg_rows<D>(dpt, va, oa);  // dP^T = V dO^T
    wg_commit();
    wg_wait0();
    const bool full = tile_full(q0, k0, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e;
        const float l = lse_s[c], dl = dl_s[c];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 2 * hr + e;
          const float p = prob(st[j][i], q0 + c, kr0 + 8 * hr, l, full, sh);
          st[j][i] = p;                      // P^T
          dpt[j][i] = p * (dpt[j][i] - dl);  // dS^T
        }
      }
    unsigned ph[4][4], plo[4][4], dh[4][4], dlo[4][4];
    split_frags(st, ph, plo);
    split_frags(dpt, dh, dlo);
    wg_fence();
    wg_hi_lo<D>(dv, ph, plo, oa);  // dv += P^T dO
    wg_hi_lo<D>(dk, dh, dlo, qa);  // dk += dS^T Q
    wg_commit();
    wg_wait0();
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = kr0 + 8 * hr;
    if (kp >= sh.Lk) continue;
    const size_t row = ((size_t)bh * sh.Lk + kp) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = 8 * j + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dkq + row + c) =
          __floats2bfloat162_rn(dk[j][2 * hr] * sh.scale,
                                dk[j][2 * hr + 1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvq + row + c) =
          __floats2bfloat162_rn(dv[j][2 * hr], dv[j][2 * hr + 1]);
    }
  }
}

// d += A.B over k16, m64n64, A and B both from shared memory and both
// MN-major: A a one-panel tile whose rows are k and whose 64 columns are
// A's rows (M), B a 64-column panel of a tile read as wg_pv reads V
__device__ __forceinline__ void wg_ss_mn(float (&d)[8][4],
                                         unsigned long long da,
                                         unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      " %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db));
}

// register A fragments of a 64 x 64 tile (split_frags' layout: this
// warp's rows 16 warp + gr, + 8, columns of k16 step kk) stored into a
// one-panel tile in shared memory, rows as rows
__device__ __forceinline__ void store_frags(char* dst,
                                            const unsigned (&f)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<unsigned*>(
          dst + pan(16 * warp + gr + 8 * (r & 1),
                    16 * kk + 8 * (r >> 1) + 2 * tq)) = f[kk][r];
}

// ------------------------------------------- K4, bf16, tensor cores
//
// The fused backward, key-major (the FA2/FA3 order): one warpgroup per
// (kv row, 64-key tile), key tile 0 first, looping over the g q heads of
// its kv head and, for each, over the band's query tiles (K3's range).
// K and V stay in shared memory; Q, dO and the tile's lse and delta
// stream through two cp.async stages, as in K3. Per (query tile, key
// tile) pair, S^T = K.Q^T and dP^T = V.dO^T are formed once, in one
// wgmma group; P^T and dS^T follow in the accumulators' layout (K3's
// precision: exact bf16 products, P and dS in f32); dv += P^T.dO and dk
// += dS^T.Q run on P's and dS's hi and lo halves from registers. dk and
// dv stay in f32 registers across every q head and query tile, so the
// GQA sum is in registers and each is written once, in bf16. The dq
// contribution dS.K needs dS with query rows, which the registers hold
// by key rows: once the dk and dv products are done with the stage's Q
// and dO tiles, dS^T's hi and lo are stored over them as one-panel tiles
// (rows = keys) and read back as the A operand MN-major (wgmma's
// transpose), against K read MN-major as K2 reads it; in 64-column
// chunks of D (32 accumulators a thread, beside dk's and dv's 128 at D =
// 128), each chunk added with 16-byte atomics into the zeroed f32 (BH,
// Lq, D) dq sum. Tensor work per pair: Q.K^T and dO.V^T once, the three
// products that take P or dS twice: 8 units against the split pair's 10
// (K2: 4, K3: 6). What bounds it: operations, 171.9 GFLOP at the train
// shape (B=8, L=2048, H=8, D=128, causal), 174 us at 989 TFLOP/s; the
// hi/lo tensor work 1.6x that (278 us); the dq sum adds 4 bytes of f32
// atomics per (query, key tile, column), 1.1 GB at that shape. At D =
// 128 it holds 255 registers with a 4-byte spill (as K3) and 98 KB of
// shared memory, two blocks an SM: 854-872 us at the train shape on an
// H100 80GB HBM3 at 700 W, against 913-943 us with 8-byte atomics and
// 1067-1123 us for two warpgroups over 128-key tiles (half the atomics,
// one block an SM, the warpgroups in lockstep), each in the same call
// (bench/flash_bwd_ab.py); the split pair K2 + K3 took 797-815 us.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_fused_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dqa,
                                 __nv_bfloat16* __restrict__ dko,
                                 __nv_bfloat16* __restrict__ dvo, Shape sh) {
  constexpr int TB = kTile * D * 2;
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  char* Ks = aligned_base(smem4);
  char* Vs = Ks + TB;
  char* Qs = Vs + TB;      // [2 stages]: Q, then dS^T's hi
  char* Os = Qs + 2 * TB;  // [2 stages]: dO, then dS^T's lo
  float* Ls = reinterpret_cast<float*>(Os + 2 * TB);  // [2 stages][64] lse
  float* Dl = Ls + 2 * kTile;                         // [2 stages][64] delta

  const int bkv = blockIdx.x;  // q rows bkv * g .. bkv * g + g - 1
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const size_t kv_off = (size_t)bkv * sh.Lk * D;
  // threads 0-63 copy lse, 64-127 delta: one float each per query tile
  float* stat_s = (tid < kTile ? Ls : Dl) + (tid & (kTile - 1));

  const int nq = (sh.Lq + kTile - 1) / kTile;
  int qt_lo = 0, qt_hi = nq - 1;
  if (sh.causal) qt_lo = blockIdx.y;
  if (sh.window > 0)
    qt_hi = min(qt_hi, (k0 + kTile - 2 + sh.window) / kTile);
  const int n_qt = qt_hi - qt_lo + 1;
  const int n_it = n_qt > 0 ? sh.g * n_qt : 0;
  // iteration it: q row bkv * g + it / n_qt, query tile qt_lo + it % n_qt

  auto load_query_tile = [&](int st, int it) {
    const int bh = bkv * sh.g + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * kTile;
    const size_t q_off = (size_t)bh * sh.Lq * D;
    load_panels<D>(Qs + st * TB, q + q_off, q0, sh.Lq);
    load_panels<D>(Os + st * TB, dout + q_off, q0, sh.Lq);
    const float* stat = (tid < kTile ? lse : delta) + (size_t)bh * sh.Lq;
    const int r = q0 + (tid & (kTile - 1));
    const bool ok = r < sh.Lq;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(stat_s + st * kTile)),
                 "l"(ok ? stat + r : stat), "r"(ok ? 4 : 0));
  };

  load_panels<D>(Ks, k + kv_off, k0, sh.Lk);
  load_panels<D>(Vs, v + kv_off, k0, sh.Lk);
  if (n_it > 0) load_query_tile(0, 0);
  cp_async_commit();

  const int kr0 = k0 + 16 * warp + gr;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const unsigned ka = smem_u32(Ks), va = smem_u32(Vs);

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_query_tile(stage ^ 1, it + 1);
    cp_async_commit();  // possibly empty: one group per tile
    cp_async_wait<1>();  // this tile's Q, dO, lse and delta have landed
    fence_async_smem();
    __syncthreads();
    const int bh = bkv * sh.g + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * kTile;
    char* Qst = Qs + stage * TB;
    char* Ost = Os + stage * TB;
    const unsigned qa = smem_u32(Qst), oa = smem_u32(Ost);
    const float* lse_s = Ls + stage * kTile;
    const float* dl_s = Dl + stage * kTile;
    // st[j], dpt[j]: queries 8j + 2tq (+1) of key rows gr, gr + 8
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    wg_fence();
    wg_rows<D>(st, ka, qa);   // S^T = K Q^T
    wg_rows<D>(dpt, va, oa);  // dP^T = V dO^T
    wg_commit();
    wg_wait0();
    const bool full = tile_full(q0, k0, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e;
        const float l = lse_s[c], dl = dl_s[c];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 2 * hr + e;
          const float p = prob(st[j][i], q0 + c, kr0 + 8 * hr, l, full, sh);
          st[j][i] = p;                      // P^T
          dpt[j][i] = p * (dpt[j][i] - dl);  // dS^T
        }
      }
    unsigned ph[4][4], plo[4][4], dh[4][4], dlo[4][4];
    split_frags(st, ph, plo);
    split_frags(dpt, dh, dlo);
    wg_fence();
    wg_hi_lo<D>(dv, ph, plo, oa);  // dv += P^T dO
    wg_hi_lo<D>(dk, dh, dlo, qa);  // dk += dS^T Q
    wg_commit();
    wg_wait0();
    __syncthreads();  // every warp's products are done with Q and dO
    store_frags(Qst, dh);
    store_frags(Ost, dlo);
    fence_async_smem();
    __syncthreads();  // dS^T's halves are in place for the tensor cores
    // dq += dS K, 64 columns of D at a time: rows gr, gr + 8 of this
    // warp's 16 queries, columns 8j + 2tq (+1) of the chunk
    const int qr = q0 + 16 * warp + gr;
    float* dq_row = dqa + ((size_t)bh * sh.Lq + qr) * D + 2 * tq;
#pragma unroll 1
    for (int c = 0; c < D / 64; ++c) {
      float dq[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
      const unsigned kc = ka + c * kPanel;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned off = kk * 2048;
        const unsigned long long db = gmma_desc(kc + off, kPanel, 1024);
        wg_ss_mn(dq, gmma_desc(qa + off, kPanel, 1024), db);  // hi
        wg_ss_mn(dq, gmma_desc(oa + off, kPanel, 1024), db);  // lo
      }
      wg_commit();
      wg_wait0();
      // lanes tq and tq ^ 1 trade a pair: an even tq then holds four
      // columns of row gr, an odd one four of row gr + 8, added as one
      // 16-byte atomic
      const int odd = tq & 1;
      float* row = dq_row + (size_t)8 * odd * D + 64 * c - 2 * odd;
      const bool in = qr + 8 * odd < sh.Lq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // each sends the row its partner adds
        const float r0 =
            __shfl_xor_sync(0xffffffffu, odd ? dq[j][0] : dq[j][2], 1);
        const float r1 =
            __shfl_xor_sync(0xffffffffu, odd ? dq[j][1] : dq[j][3], 1);
        if (in)
          atomicAdd(reinterpret_cast<float4*>(row + 8 * j),
                    odd ? make_float4(r0, r1, dq[j][2], dq[j][3])
                        : make_float4(dq[j][0], dq[j][1], r0, r1));
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = kr0 + 8 * hr;
    if (kp >= sh.Lk) continue;
    const size_t row = ((size_t)bkv * sh.Lk + kp) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = 8 * j + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dko + row + c) =
          __floats2bfloat162_rn(dk[j][2 * hr] * sh.scale,
                                dk[j][2 * hr + 1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvo + row + c) =
          __floats2bfloat162_rn(dv[j][2 * hr], dv[j][2 * hr + 1]);
    }
  }
}

}  // namespace tc

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

// Key-major (see the FMA note at the top): dk, dv of one kv row's key
// tile over its group's q heads and their query tiles; each pair's dS.K
// added into the f32 dq sum.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dqa, T* __restrict__ dko,
                           T* __restrict__ dvo, Shape sh) {
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

  const int bkv = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t kv_off = (size_t)bkv * sh.Lk * D;

  load_tile<T, D>(Ks, DS, k + kv_off, k0, sh.Lk);
  load_tile<T, D>(Vs, DS, v + kv_off, k0, sh.Lk);
  // rows ty + 16 i are KEY rows here, columns tx + 16 j of D
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (sh.Lq + kTile - 1) / kTile;
  for (int gi = 0; gi < sh.g; ++gi) {
    const int bh = bkv * sh.g + gi;
    const size_t q_off = (size_t)bh * sh.Lq * D;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_runs(q0, k0, sh)) continue;
      __syncthreads();
      load_tile<T, D>(Qs, DS, q + q_off, q0, sh.Lq);
      load_tile<T, D>(Os, DS, dout + q_off, q0, sh.Lq);
      load_rows(LSEs, lse + (size_t)bh * sh.Lq, q0, sh.Lq);
      load_rows(DLs, delta + (size_t)bh * sh.Lq, q0, sh.Lq);
      __syncthreads();
      probs_and_ds<D, true>(Ps, Ds, Qs, Os, Ks, Vs, LSEs, DLs, q0, k0, sh,
                            ty, tx);
      __syncthreads();
      score_times<D, true>(dv, Ps, Os, DS, ty, tx);  // dv += P^T dO
      score_times<D, true>(dk, Ds, Qs, DS, ty, tx);  // dk += dS^T Q
      // this pair's dq contribution to query rows q0 + ty + 16 i
      float part[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) part[i][j] = 0.f;
      score_times<D, false>(part, Ds, Ks, DS, ty, tx);  // dS K
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty + 16 * i;
        if (qr >= sh.Lq) continue;
        float* row = dqa + ((size_t)bh * sh.Lq + qr) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) atomicAdd(row + tx + 16 * j, part[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= sh.Lk) continue;
    const size_t row = ((size_t)bkv * sh.Lk + kr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      put(dko + row + tx + 16 * j, dk[i][j] * sh.scale);
      put(dvo + row + tx + 16 * j, dv[i][j]);
    }
  }
}

// K4's last pass: dq = scale * (the f32 dq sum), in dq's type; n4 is the
// number of float4s (D is a multiple of 4)
template <typename T>
__global__ void __launch_bounds__(256)
    dq_finish_kernel(const float4* __restrict__ acc, T* __restrict__ dq,
                     size_t n4, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = acc[i];
    T* o = dq + 4 * i;
    put(o, a.x * scale);
    put(o + 1, a.y * scale);
    put(o + 2, a.z * scale);
    put(o + 3, a.w * scale);
  }
}

// ------------------------------------------------------------ launching

enum Kernel { kFwd, kDq, kDkv, kFused };

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *out_lse, *d1, *d2, *d3;
  float* acc;  // K4's f32 dq sum
  int BH;
  Shape sh;
  cudaStream_t stream;
};

// dynamic shared memory of a kernel's block. The tensor-core kernels
// (bf16 K1-K4) hold bf16 64 x D tiles, what follows them, and room to
// align the tiles to 1024 bytes; the FMA kernels hold f32 tiles with
// padded rows.
template <typename T, int D>
size_t smem_bytes(Kernel which) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t tile = (size_t)kTile * D * 2;
    switch (which) {
      case kFwd:  // Q, two K stages, V
        return 4 * tile + 1024;
      case kDq:  // Q, dO, two K and two V stages
        return 6 * tile + 1024;
      case kDkv:    // K, V, two Q and two dO stages, two of lse and delta
      case kFused:  // the same; dS^T's halves go over a Q and a dO stage
        return 6 * tile + 4 * kTile * sizeof(float) + 1024;
    }
  }
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
  const size_t smem = smem_bytes<T, D>(which);
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
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        auto kern = tc::flash_fwd_wgmma_kernel<D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(a.BH, nq), tc::kThreads, smem, a.stream>>>(
            q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.out_lse),
            a.sh);
      } else {
        auto kern = flash_fwd_kernel<T, D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(nq, a.BH), kThreads, smem, a.stream>>>(
            q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.out_lse),
            a.sh);
      }
      break;
    }
    case kDq: {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        auto kern = tc::flash_bwd_dq_wgmma_kernel<D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(a.BH, nq), tc::kThreads, smem, a.stream>>>(
            q, k, v, dout, lse, delta, static_cast<T*>(a.d1), a.sh);
      } else {
        auto kern = flash_bwd_dq_kernel<T, D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(nq, a.BH), kThreads, smem, a.stream>>>(
            q, k, v, dout, lse, delta, static_cast<T*>(a.d1), a.sh);
      }
      break;
    }
    case kDkv: {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        auto kern = tc::flash_bwd_dkv_wgmma_kernel<D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(a.BH, nk), tc::kThreads, smem, a.stream>>>(
            q, k, v, dout, lse, delta, static_cast<T*>(a.d1),
            static_cast<T*>(a.d2), a.sh);
      } else {
        auto kern = flash_bwd_dkv_kernel<T, D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(nk, a.BH), kThreads, smem, a.stream>>>(
            q, k, v, dout, lse, delta, static_cast<T*>(a.d1),
            static_cast<T*>(a.d2), a.sh);
      }
      break;
    }
    case kFused: {
      const int bhkv = a.BH / a.sh.g;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        auto kern = tc::flash_bwd_fused_wgmma_kernel<D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(bhkv, nk), tc::kThreads, smem, a.stream>>>(
            q, k, v, dout, lse, delta, a.acc, static_cast<T*>(a.d2),
            static_cast<T*>(a.d3), a.sh);
      } else {
        auto kern = flash_bwd_fused_kernel<T, D>;
        if ((e = prepare(kern, smem)) != cudaSuccess) return e;
        kern<<<dim3(nk, bhkv), kThreads, smem, a.stream>>>(
            q, k, v, dout, lse, delta, a.acc, static_cast<T*>(a.d2),
            static_cast<T*>(a.d3), a.sh);
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      const size_t n4 = (size_t)a.BH * a.sh.Lq * D / 4;
      const int blocks = (int)(n4 < 256 * 4096 ? (n4 + 255) / 256 : 4096);
      dq_finish_kernel<T><<<blocks, 256, 0, a.stream>>>(
          reinterpret_cast<const float4*>(a.acc), static_cast<T*>(a.d1), n4,
          a.sh.scale);
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
// of one type (f32 or bf16, is_bf16); lse, delta and K4's dq sum f32.
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

// K4: dq (BH, Lq, D); dk, dv summed over the GQA group, (BH/g, Lk, D).
// dqa is an f32 (BH, Lq, D) scratch, ZEROED by the caller: the fused
// kernel adds into it, then a second launch writes dq from it.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dqa, void* dq,
                               void* dk, void* dv, int BH, int g, int Lq,
                               int Lk, int D, float scale, int causal,
                               int window, int is_bf16, void* stream) {
  Args a = make_args(BH, g, Lq, Lk, scale, causal, window, stream);
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.acc = static_cast<float*>(dqa), a.d1 = dq, a.d2 = dk, a.d3 = dv;
  return run(kFused, D, is_bf16, a);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
