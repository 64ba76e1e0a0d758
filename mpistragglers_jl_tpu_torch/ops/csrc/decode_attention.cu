// Int8 KV-cache decode attention for Hopper (sm_90a): the dense kernel,
// its paged mode and its attribution variants.
//
// Replaces two TPU kernels of mpistragglers_jl_tpu/ops/decode_attention.py:
// `_kernel` (K5, launched by `quantized_decode_attention`) and
// `_paged_kernel` (K6, launched by `_paged_call`), and K7 (below). One
// query token per row attends an int8 K/V cache with f32
// per-(position, head) scales,
// GQA group g = H / Hkv <= 8:
//   s = (q . k) * scale * k_s      p = softmax over the visible keys
//   o = sum p * v_s * v / max(l, 1e-20)
// Visibility is the reference's: positional (kpos <= pos, and
// pos - kpos < window when window > 0) or ring (slot s valid iff
// s <= pos or pos >= W). Both are one contiguous key range [lo, hi]
// per row, computed on the device from pos, so the kernel reads no
// key outside it and the host never syncs.
//
// Layouts. Dense (K5): k, v (B, L, Hkv, D), scales (B, L, Hkv); key t of
// row b is cache row b*L + t. Paged (K6, ring only): k, v are a pool
// (n_pages*P, Hkv, D) shared by all rows, scales (n_pages*P, Hkv), and
// a (B, max_pages) int32 page table maps ring page j of row b to a pool
// page; key slot t of row b is pool row pt[b, t/P]*P + t%P, W =
// max_pages*P. The block loads its page-table row into shared memory
// once and addresses every key through it, so a 32-key tile may
// straddle pages and every page size P >= 1 is taken. A page id outside
// the pool is never dereferenced: its keys count as masked.
//
// What bounds it: bytes. One launch at the serving shape (B=8,
// L=W=1024, Hkv=2, D=128, g=4) reads 4,194,304 B of int8 K/V, 131,072 B
// of scales and writes/reads 32 KB of q and out (paged: plus 512 B of
// page table), about 4.36 MB, or 1.30 us at 3.35 TB/s; at B=1, L=16384
// 8.65 MB, 2.58 us. Its 34 MFLOP are negligible beside that. The first
// design (one block per (kv head, row), 32-key tiles walked one after
// the other) was latency-bound: two blocks at B=1 walked 512 tiles each.
//
// Design: split-K over the key range (flash-decoding).
// * Grid (Hkv, B, n_split): split s owns keys [s*chunk, (s+1)*chunk),
//   a run of whole 32-key tiles, intersected with the row's visible
//   range. The wrapper picks chunk and n_split on the host from (B,
//   Hkv, L) alone (`split_plan` in ops/decode_attention.py), so a
//   decode step never syncs and the call stays capturable in a CUDA
//   graph.
// * Inside the block every warp works: the chunk's tiles are dealt out
//   round robin, each warp carrying its own online-softmax state (m, l,
//   acc[D]) for all g q rows of the group. Lane j owns key j of a tile
//   (its score for every row) and 4 of every 128 columns of acc (p_j
//   broadcast by a shuffle).
// * Each warp streams its tiles through a private two-stage ring of raw
//   int8 tiles in shared memory, filled by 16-byte cp.async (4-byte for
//   the scales): the next tile's loads are in flight while the current
//   one is dequantised from shared memory and computed. Out-of-range
//   rows are zero-filled by the copy, never read. K rows are padded by
//   16 bytes, so a lane reading its own key row is conflict-free.
// * The warps merge through shared memory with the combine algebra
//   (M = max m_w, l = sum l_w e^(m_w - M), acc = sum acc_w e^(m_w - M)).
//   With one split the block writes o itself; otherwise it writes its
//   partial (m, l, acc) in f32 to a scratch the wrapper allocates, and
//   `decode_combine_kernel` (one block per (kv head, row), one warp per
//   q row) folds the splits the same way and writes o in q's type. A
//   chunk with nothing visible (ring warm-up, the causal frontier, the
//   window's lower edge) writes m = -1e30, l = 0, acc = 0; a row with
//   nothing visible returns zeros.
// * Both launches go on the caller's stream; each is checked with
//   cudaGetLastError() and the C entries return the first error.
// * K6 runs the same template over the same split grid: its chunk comes
//   from `paged_split_plan` (ops/decode_attention.py), K5's chunk rounded
//   up to whole pages where that at most doubles it, and its partials
//   fold through the same combine. The block addresses every key through
//   its row of the page table, so a split may start anywhere. TMA is
//   later work.
// * What one block costs (H100 80GB HBM3, 700 W; chip_smoke.py phase 10,
//   K6 at the serving shape with 1 to 32 splits): at D = 128 the block
//   holds 128 registers and no local memory, and its 143 KB ring allows
//   one block an SM. A warp's 32-key tile is about 10 us of latency (one
//   warp walks it alone: ~3000 dependent instructions, shuffles and
//   shared-memory loads), and launch, merge and combine about 7 us: 17-18
//   us with one tile a warp (128 or 256 slots a split), 28 us with two or
//   with a second wave of blocks, 46 us with four (one split).
//
// K7, the attribution variants of benchmarks/decode_kernel_attrib.py
// (`variant(mode)`), is the template's MODE parameter: the same grid,
// split, tiles and cp.async ring, with only what runs after a tile
// lands stripped down, so a redesign of K5 carries them along. FULL is
// K5/K6 itself (every other branch below is `if constexpr`). The
// variants walk every key (the reference runs them at pos = L - 1) and
// write f32 (B, H, D); segments are the reference's k-blocks,
// [j*block_k, (j+1)*block_k) cut at L, and K7's chunk divides block_k,
// so a split never straddles two:
//   DMA      out[b, 0, 0] = sum_j (k[b, j*bk, 0, 0] + v[b, j*bk, 0, 0])
//   DOT      out[b, h*g+i, 0] = sum_j max_{l in seg j} (q_i . k_l) * scale
//   DEQUANT  the same with s_l * k_s[l, h]
//   NOSM     out[b, h*g+i, :] = sum_l s_l * k_s[l,h] * v_s[l,h] * v_l
// all other entries 0. Each mode's combine is its own algebra: DMA and
// NOSM sum their partials; DOT and DEQUANT take the maximum within a
// segment, then sum over segments. Every mode copies every tile into
// shared memory (cp.async is never dead code), so each variant moves
// what K5 moves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // keys per warp tile: lane j owns key j
constexpr int kMaxGroup = 8;
constexpr int kStages = 2;  // cp.async ring depth of each warp
constexpr int kCombineThreads = 256;
constexpr float kNeg = -1e30f;

enum Mode : int { FULL = 0, DMA = 1, DOT = 2, DEQUANT = 3, NOSM = 4 };

// Per head_dim D = DV * 128: warps a block, padded K row, bytes a stage.
// Fewer warps for wide heads keep the ring within shared memory.
template <int DV>
struct Cfg {
  static constexpr int D = DV * 128;
  static constexpr int NW = DV == 1 ? 8 : DV == 2 ? 4 : 2;
  static constexpr int THREADS = NW * 32;
  static constexpr int KS = D + 16;  // K row stride in bytes
  static constexpr int CH = D / 16;  // 16-byte pieces per cache row
  static constexpr int STAGE = kTile * KS + kTile * D + 2 * kTile * 4;
  static constexpr int RING = NW * kStages * STAGE;
  // the warps' merge scratch, aliasing the ring after the loop
  static constexpr int MERGE = NW * kMaxGroup * (D + 2) * 4;
  static constexpr int BODY = RING > MERGE ? RING : MERGE;
  static constexpr int QS = kMaxGroup * D * 4;  // q rows in f32
};

// the output element type: q's for the shipped kernel, f32 for K7
template <int MODE, typename T>
struct OutT {
  using type = float;
};
template <typename T>
struct OutT<FULL, T> {
  using type = T;
};

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

// byte `i` of w as a signed int8, in f32: the byte plus 128 becomes the
// low mantissa byte of 2^23 (one byte permute and one add, exact)
__device__ __forceinline__ float sbyte(int w, int i) {
  const unsigned u = (unsigned)w ^ 0x80808080u;
  return __int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
         8388736.f;
}

// cp.async of `bytes` (16 or 4) from global to shared; src_bytes 0
// zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dense: pt == nullptr, P and n_pages unused. Paged: L == W ==
// max_pages * P, ring == 1, window == 0. block_k is read
// by the K7 modes only; they read neither pos, window nor ring. With
// n_split == 1 the block writes `out`; otherwise its partial goes to
// pm, pl (B, Hkv, n_split, g) and pacc (B, Hkv, n_split, g, D).
template <typename T, int DV, bool PAGED, int MODE>
__global__ void __launch_bounds__(Cfg<DV>::THREADS)
    decode_split_kernel(const T* __restrict__ q,
                        const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ pos,
                        const int* __restrict__ pt,
                        typename OutT<MODE, T>::type* __restrict__ out,
                        float* __restrict__ pm, float* __restrict__ pl,
                        float* __restrict__ pacc, int L, int Hkv, int g,
                        float scale, int window, int ring, int P,
                        int n_pages, int block_k, int chunk, int n_split) {
  using C = Cfg<DV>;
  constexpr int D = C::D, KS = C::KS, CH = C::CH, NW = C::NW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kMaxGroup][D]
  char* body = reinterpret_cast<char*>(smem4) + C::QS;
  int* Pt = reinterpret_cast<int*>(body + C::BODY);  // [max_pages], paged

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hkv * g;

  // this row's visible key range (the K7 modes see every key) ...
  int lo = 0, hi = L - 1;
  if constexpr (MODE == FULL) {
    const int p = pos[b];
    if (ring) {
      hi = p >= L ? L - 1 : p;
    } else {
      hi = p < L - 1 ? p : L - 1;
      if (window > 0 && p - window + 1 > 0) lo = p - window + 1;
    }
  }
  // ... cut to this split's chunk: keys [a, e]
  const int c0 = split * chunk;
  const int a = lo > c0 ? lo : c0;
  const int e = hi < c0 + chunk - 1 ? hi : c0 + chunk - 1;
  const int n_tiles = e >= a ? (e - a) / kTile + 1 : 0;

  const T* qb = q + ((size_t)b * H + (size_t)h * g) * D;
  for (int x = tid; x < g * D; x += C::THREADS) Qs[x] = to_f32(qb[x]);
  if (PAGED) {
    const int max_pages = L / P;
    const int* ptb = pt + (size_t)b * max_pages;
    for (int x = tid; x < max_pages; x += C::THREADS) Pt[x] = ptb[x];
  }
  __syncthreads();  // Qs and Pt are read by every warp below

  // cache row of key slot t (a <= t <= e), or -1 when its page lies
  // outside the pool (the key then counts as masked)
  auto cache_row = [&](int t) -> long long {
    if (!PAGED) return (long long)b * L + t;
    const int pg = Pt[t / P];
    return (unsigned)pg < (unsigned)n_pages ? (long long)pg * P + t % P
                                             : -1ll;
  };

  const size_t row = (size_t)Hkv * D;  // bytes between cache rows
  const int8_t* kh = k + (size_t)h * D;
  const int8_t* vh = v + (size_t)h * D;
  const float* ksh = ks + h;
  const float* vsh = vs + h;
  char* ring_w = body + warp * kStages * C::STAGE;  // this warp's ring

  // this warp's i-th tile starts at key a + (warp + i * NW) * kTile
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
  auto issue = [&](int i) {
    const int base = a + (warp + i * NW) * kTile;
    int8_t* Kst = reinterpret_cast<int8_t*>(ring_w + (i & 1) * C::STAGE);
    int8_t* Vst = Kst + kTile * KS;
    float* Sst = reinterpret_cast<float*>(Vst + kTile * D);
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int c = lane + 32 * u;
      const int r = c / CH, col = (c % CH) * 16;
      const int t = base + r;
      const long long cr = t <= e ? cache_row(t) : -1ll;
      const bool ok = cr >= 0;
      cp_async16(Kst + r * KS + col, ok ? kh + cr * row + col : kh,
                 ok ? 16 : 0);
      cp_async16(Vst + r * D + col, ok ? vh + cr * row + col : vh,
                 ok ? 16 : 0);
    }
    const int t = base + lane;
    const long long cr = t <= e ? cache_row(t) : -1ll;
    const bool ok = cr >= 0;
    cp_async4(Sst + lane, ok ? ksh + cr * Hkv : ksh, ok ? 4 : 0);
    cp_async4(Sst + kTile + lane, ok ? vsh + cr * Hkv : vsh, ok ? 4 : 0);
    cp_async_commit();
  };

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][4 * DV];
  float seg = 0.f;  // DMA: this warp's segment-start sum
#pragma unroll
  for (int i = 0; i < kMaxGroup; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DV; ++c) acc[i][c] = 0.f;
  }

  if (my_tiles > 0) issue(0);
  for (int it = 0; it < my_tiles; ++it) {
    if (it + 1 < my_tiles) {
      issue(it + 1);  // in flight behind this tile's maths
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this stage have landed
    const int base = a + (warp + it * NW) * kTile;
    const int8_t* Kst =
        reinterpret_cast<const int8_t*>(ring_w + (it & 1) * C::STAGE);
    const int8_t* Vst = Kst + kTile * KS;
    const float* Sst = reinterpret_cast<const float*>(Vst + kTile * D);
    if constexpr (MODE == DMA) {
      // the reference's acc[0, 0] += k[0, 0] + v[0, 0] per k-block: the
      // segment's first key, kv head 0, column 0 (chunks divide block_k,
      // so a segment starts only at a chunk's first key)
      if (lane == 0 && h == 0 && it == 0 && warp == 0 && base % block_k == 0)
        seg += (float)Kst[0] + (float)Vst[0];
    } else {
      const int t = base + lane;
      const bool valid = t <= e && cache_row(t) >= 0;
      // scores of key `lane` against every q row of the group
      float s0[kMaxGroup], s1[kMaxGroup];
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) s0[i] = s1[i] = 0.f;
      const int4* k4 = reinterpret_cast<const int4*>(Kst + lane * KS);
#pragma unroll 2
      for (int x = 0; x < CH; ++x) {
        const int4 kr = k4[x];
        const int w[4] = {kr.x, kr.y, kr.z, kr.w};
        float kf[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) kf[c] = sbyte(w[c >> 2], c & 3);
#pragma unroll
        for (int i = 0; i < kMaxGroup; ++i) {
          if (i < g) {
            const float4* q4 =
                reinterpret_cast<const float4*>(Qs + i * D + 16 * x);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float4 qq = q4[c];
              float& sa = (c & 1) ? s1[i] : s0[i];
              sa = fmaf(qq.x, kf[4 * c + 0], sa);
              sa = fmaf(qq.y, kf[4 * c + 1], sa);
              sa = fmaf(qq.z, kf[4 * c + 2], sa);
              sa = fmaf(qq.w, kf[4 * c + 3], sa);
            }
          }
        }
      }
      float pv[kMaxGroup];
#pragma unroll
      for (int i = 0; i < kMaxGroup; ++i) {
        pv[i] = 0.f;
        if (i < g) {
          float sc = (s0[i] + s1[i]) * scale;
          if constexpr (MODE != DOT) sc *= Sst[lane];
          if constexpr (MODE == FULL) {
            const float m_new = fmaxf(m[i], warp_max(valid ? sc : kNeg));
            const float p = valid ? expf(sc - m_new) : 0.f;
            const float corr = expf(m[i] - m_new);
            l[i] = l[i] * corr + warp_sum(p);
            m[i] = m_new;
            pv[i] = p * Sst[kTile + lane];
#pragma unroll
            for (int c = 0; c < 4 * DV; ++c) acc[i][c] *= corr;
          } else if constexpr (MODE == NOSM) {
            pv[i] = valid ? sc * Sst[kTile + lane] : 0.f;
          } else {  // DOT, DEQUANT: a running max over the chunk
            m[i] = fmaxf(m[i], warp_max(valid ? sc : kNeg));
          }
        }
      }
      if constexpr (MODE == FULL || MODE == NOSM) {
        // acc[i] += sum_j pv_ij * V[j, this lane's columns]
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
          float vf[4 * DV];
#pragma unroll
          for (int u = 0; u < DV; ++u) {
            const int w = *reinterpret_cast<const int*>(Vst + j * D +
                                                        u * 128 + lane * 4);
#pragma unroll
            for (int c = 0; c < 4; ++c) vf[4 * u + c] = sbyte(w, c);
          }
#pragma unroll
          for (int i = 0; i < kMaxGroup; ++i) {
            if (i < g) {
              const float pj = __shfl_sync(0xffffffffu, pv[i], j);
#pragma unroll
              for (int c = 0; c < 4 * DV; ++c)
                acc[i][c] = fmaf(pj, vf[c], acc[i][c]);
            }
          }
        }
      }
    }
    __syncwarp();  // this stage is refilled two tiles on
  }

  // merge the warps through shared memory (the ring is free now)
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(body);  // [NW][kMaxGroup]
  float* Lw = Mw + NW * kMaxGroup;             // [NW][kMaxGroup]
  float* Aw = Lw + NW * kMaxGroup;             // [NW][kMaxGroup][D]
#pragma unroll
  for (int i = 0; i < kMaxGroup; ++i) {
    if (i < g) {
      if (lane == 0) {
        Mw[warp * kMaxGroup + i] = MODE == DMA ? seg : m[i];
        Lw[warp * kMaxGroup + i] = l[i];
      }
      if constexpr (MODE == FULL || MODE == NOSM) {
#pragma unroll
        for (int u = 0; u < DV; ++u)
          *reinterpret_cast<float4*>(Aw + (warp * kMaxGroup + i) * D +
                                     u * 128 + lane * 4) =
              make_float4(acc[i][4 * u], acc[i][4 * u + 1],
                          acc[i][4 * u + 2], acc[i][4 * u + 3]);
      }
    }
  }
  __syncthreads();

  const size_t part = ((size_t)(b * Hkv + h) * n_split + split) * g;
  for (int x = tid; x < g * D; x += C::THREADS) {
    const int i = x / D, col = x % D;
    float M = kNeg, lsum = 0.f, asum = 0.f;
    if constexpr (MODE == FULL) {
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * kMaxGroup + i]);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = expf(Mw[w * kMaxGroup + i] - M);
        lsum += Lw[w * kMaxGroup + i] * f;
        asum += Aw[(w * kMaxGroup + i) * D + col] * f;
      }
    } else if constexpr (MODE == NOSM) {
#pragma unroll
      for (int w = 0; w < NW; ++w) asum += Aw[(w * kMaxGroup + i) * D + col];
    } else if constexpr (MODE == DMA) {
      M = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) M += Mw[w * kMaxGroup];
    } else {  // DOT, DEQUANT
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * kMaxGroup + i]);
    }
    if (n_split == 1) {
      typename OutT<MODE, T>::type* ob =
          out + ((size_t)b * H + (size_t)h * g + i) * D;
      if constexpr (MODE == FULL) {
        put(ob + col, asum / fmaxf(lsum, 1e-20f));
      } else if constexpr (MODE == NOSM) {
        ob[col] = asum;
      } else if constexpr (MODE == DMA) {
        ob[col] = (h == 0 && i == 0 && col == 0) ? M : 0.f;
      } else {
        ob[col] = col == 0 ? M : 0.f;
      }
    } else {
      if constexpr (MODE == FULL || MODE == NOSM)
        pacc[(part + i) * D + col] = asum;
      if (col == 0) {
        pm[part + i] = M;
        pl[part + i] = lsum;
      }
    }
  }
}

// Folds the n_split partials of one (kv head h, row b). FULL: warp i < g
// finds q row i's M = max m_s and the weights e^(m_s - M) into shared
// memory; then every thread sums the weighted acc of some (row, 4
// columns) pair over a share of the splits (the splits dealt out to
// groups of threads, so many loads are in flight), and the groups'
// sums meet in shared memory. NOSM weighs every split 1. DMA, DOT and
// DEQUANT fold one number per row. per_seg (DOT, DEQUANT) is the
// number of splits in one block_k segment.
template <typename OT, int DV, int MODE>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(const float* __restrict__ pm,
                          const float* __restrict__ pl,
                          const float* __restrict__ pacc,
                          OT* __restrict__ out, int Hkv, int g, int n_split,
                          int per_seg) {
  constexpr int D = DV * 128, Q4 = D / 4;
  extern __shared__ float4 csm4[];
  float4* Red = csm4;                               // [kCombineThreads]
  float* Lrow = reinterpret_cast<float*>(Red + kCombineThreads);  // [g]
  float* W = Lrow + kMaxGroup;                      // [g][n_split]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hkv * g;
  OT* ob = out + ((size_t)b * H + (size_t)h * g) * D;  // q row 0 of h
  const size_t first = (size_t)(b * Hkv + h) * n_split * g;
  // partial s of q row i: index first + s * g + i
  if constexpr (MODE == FULL || MODE == NOSM) {
    if (warp < g) {
      const int i = warp;
      float M = kNeg, lsum = 0.f;
      if constexpr (MODE == FULL) {
        for (int s = lane; s < n_split; s += 32)
          M = fmaxf(M, pm[first + s * g + i]);
        M = warp_max(M);
      }
      for (int s = lane; s < n_split; s += 32) {
        const float w = MODE == FULL ? expf(pm[first + s * g + i] - M) : 1.f;
        W[i * n_split + s] = w;
        if constexpr (MODE == FULL) lsum += pl[first + s * g + i] * w;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) Lrow[i] = MODE == FULL ? fmaxf(lsum, 1e-20f) : 1.f;
    }
    __syncthreads();
    const int pairs = g * Q4;  // (q row, 4 columns) pairs
    const int groups = kCombineThreads / pairs > 0 ? kCombineThreads / pairs
                                                   : 1;
    const int grp = tid / pairs;
    for (int x = tid % pairs; x < pairs && grp < groups;
         x += kCombineThreads) {
      const int i = x / Q4, c4 = x % Q4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = grp; s < n_split; s += groups) {
        const float w = W[i * n_split + s];
        const float4 a = *reinterpret_cast<const float4*>(
            pacc + (first + (size_t)s * g + i) * D + 4 * c4);
        acc.x = fmaf(w, a.x, acc.x);
        acc.y = fmaf(w, a.y, acc.y);
        acc.z = fmaf(w, a.z, acc.z);
        acc.w = fmaf(w, a.w, acc.w);
      }
      if (pairs >= kCombineThreads) {  // one group: write directly
        const float den = Lrow[i];
        OT* o = ob + (size_t)i * D + 4 * c4;
        put(o + 0, acc.x / den);
        put(o + 1, acc.y / den);
        put(o + 2, acc.z / den);
        put(o + 3, acc.w / den);
      } else {
        Red[tid] = acc;
      }
    }
    if (pairs < kCombineThreads) {
      __syncthreads();
      for (int x = tid; x < pairs; x += kCombineThreads) {
        float4 acc = Red[x];
        for (int k = 1; k < groups; ++k) {
          const float4 a = Red[k * pairs + x];
          acc.x += a.x;
          acc.y += a.y;
          acc.z += a.z;
          acc.w += a.w;
        }
        const int i = x / Q4, c4 = x % Q4;
        const float den = Lrow[i];
        OT* o = ob + (size_t)i * D + 4 * c4;
        put(o + 0, acc.x / den);
        put(o + 1, acc.y / den);
        put(o + 2, acc.z / den);
        put(o + 3, acc.w / den);
      }
    }
  } else {
    if (warp < g) {
      const int i = warp;
      float total = 0.f;
      if (lane == 0) {
        if constexpr (MODE == DMA) {
          if (h == 0 && i == 0)
            for (int s = 0; s < n_split; ++s) total += pm[first + s * g];
        } else {  // DOT, DEQUANT: max within each segment, sum over them
          for (int s0 = 0; s0 < n_split; s0 += per_seg) {
            float mx = kNeg;
            for (int s = s0; s < s0 + per_seg && s < n_split; ++s)
              mx = fmaxf(mx, pm[first + s * g + i]);
            total += mx;
          }
        }
      }
      for (int col = lane; col < D; col += 32)
        put(ob + (size_t)i * D + col, col == 0 ? total : 0.f);
    }
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pos, *pt;
  void* out;
  float *pm, *pl, *pacc;
  int B, L, Hkv, g;
  float scale;
  int window, ring, P, n_pages, block_k, chunk, n_split;
  cudaStream_t stream;
};

template <typename T, int DV, bool PAGED, int MODE>
cudaError_t launch(const Args& a) {
  using C = Cfg<DV>;
  using OT = typename OutT<MODE, T>::type;
  const size_t smem = C::QS + C::BODY +
                      (PAGED ? sizeof(int) * (size_t)(a.L / a.P) : 0);
  auto kern = decode_split_kernel<T, DV, PAGED, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.Hkv, a.B, a.n_split), C::THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const int8_t*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.pt), static_cast<OT*>(a.out), a.pm, a.pl,
      a.pacc, a.L, a.Hkv, a.g, a.scale, a.window, a.ring, a.P, a.n_pages,
      a.block_k, a.chunk, a.n_split);
  if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 1) return err;
  auto comb = decode_combine_kernel<OT, DV, MODE>;
  const size_t csmem = sizeof(float4) * kCombineThreads +
                       sizeof(float) * (kMaxGroup + (size_t)a.g * a.n_split);
  if (csmem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           comb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem)) !=
          cudaSuccess)
    return err;
  comb<<<dim3(a.Hkv, a.B), kCombineThreads, csmem, a.stream>>>(
          a.pm, a.pl, a.pacc, static_cast<OT*>(a.out), a.Hkv, a.g,
          a.n_split, a.block_k > 0 ? a.block_k / a.chunk : 1);
  return cudaGetLastError();
}

template <typename T, bool PAGED, int MODE>
cudaError_t dispatch(int D, const Args& a) {
  switch (D) {
    case 128:
      return launch<T, 1, PAGED, MODE>(a);
    case 256:
      return launch<T, 2, PAGED, MODE>(a);
    case 384:
      return launch<T, 3, PAGED, MODE>(a);
    case 512:
      return launch<T, 4, PAGED, MODE>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool PAGED, int MODE = FULL>
int run(int D, int is_bf16, const Args& a) {
  if (a.g < 1 || a.g > kMaxGroup || a.B < 1 || a.L < 1 || a.Hkv < 1 ||
      a.B > 65535 || a.n_split < 1 || a.n_split > 65535 ||
      a.chunk < kTile || a.chunk % kTile != 0 ||
      (long long)a.chunk * a.n_split < a.L ||
      (long long)a.chunk * (a.n_split - 1) >= a.L ||
      (a.n_split > 1 && (!a.pm || !a.pl || (MODE == FULL || MODE == NOSM)
                                               && !a.pacc)))
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16, PAGED, MODE>(D, a)
                       : dispatch<float, PAGED, MODE>(D, a));
}

}  // namespace

// K5. q (B, 1, Hkv*g, D) f32 or bf16; k, v (B, L, Hkv, D) int8; ks, vs
// (B, L, Hkv) f32; pos (B,) int32; out like q. All contiguous, all on
// the current device. window <= 0 means no window. Split s covers keys
// [s*chunk, (s+1)*chunk), chunk a multiple of 32, n_split =
// ceil(L / chunk); with n_split > 1, pm and pl are f32 (B, Hkv,
// n_split, g) and pacc f32 (B, Hkv, n_split, g, D) scratch (otherwise
// unused, may be null). Launches the split kernel and, with n_split > 1,
// the combine. Returns the first CUDA error code (0 on success).
extern "C" int k5_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, void* out, void* pm, void* pl,
    void* pacc, int B, int L, int Hkv, int g, int D, float scale, int window,
    int ring, int chunk, int n_split, int is_bf16, void* stream) {
  const Args a{q, k, v, ks, vs, pos, /*pt=*/nullptr, out,
               static_cast<float*>(pm), static_cast<float*>(pl),
               static_cast<float*>(pacc), B, L, Hkv, g, scale, window, ring,
               /*P=*/1, /*n_pages=*/0, /*block_k=*/0, chunk, n_split,
               static_cast<cudaStream_t>(stream)};
  return run<false>(D, is_bf16, a);
}

// K7, positional layout, every key visible. mode 1 DMA, 2 DOT,
// 3 DEQUANT, 4 NOSM (the header note gives each function). q
// (B, 1, Hkv*g, D) f32 or bf16; k, v (B, L, Hkv, D) int8; ks, vs
// (B, L, Hkv) f32; out (B, Hkv*g, D) f32. block_k > 0, a multiple of
// 32; chunk divides block_k; scratch as K5's (DMA, DOT and DEQUANT
// leave pacc unread).
// Returns the first CUDA error code.
extern "C" int k7_decode_attention_attrib(
    int mode, int block_k, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, void* out, void* pm, void* pl,
    void* pacc, int B, int L, int Hkv, int g, int D, float scale, int chunk,
    int n_split, int is_bf16, void* stream) {
  if (block_k < kTile || block_k % kTile != 0 || chunk < 1 ||
      block_k % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, ks, vs, /*pos=*/nullptr, /*pt=*/nullptr, out,
               static_cast<float*>(pm), static_cast<float*>(pl),
               static_cast<float*>(pacc), B, L, Hkv, g, scale, /*window=*/0,
               /*ring=*/0, /*P=*/1, /*n_pages=*/0, block_k, chunk, n_split,
               static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case DMA:
      return run<false, DMA>(D, is_bf16, a);
    case DOT:
      return run<false, DOT>(D, is_bf16, a);
    case DEQUANT:
      return run<false, DEQUANT>(D, is_bf16, a);
    case NOSM:
      return run<false, NOSM>(D, is_bf16, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6, ring mode through a page table. q (B, 1, Hkv*g, D) f32 or bf16;
// k, v (n_pages*P, Hkv, D) int8; ks, vs (n_pages*P, Hkv) f32; pt
// (B, max_pages) int32; pos (B,) int32; out like q. All contiguous, all
// on the current device. Split s covers ring slots [s*chunk,
// (s+1)*chunk) of W = max_pages*P (chunk a multiple of 32, n_split =
// ceil(W / chunk)); scratch as K5's. Launches the split kernel and,
// with n_split > 1, the combine. Returns the first CUDA error code.
extern "C" int k6_paged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, const void* pt, void* out, void* pm,
    void* pl, void* pacc, int B, int max_pages, int P, int n_pages, int Hkv,
    int g, int D, float scale, int chunk, int n_split, int is_bf16,
    void* stream) {
  if (P < 1 || max_pages < 1 || n_pages < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, ks, vs, pos, pt, out,
               static_cast<float*>(pm), static_cast<float*>(pl),
               static_cast<float*>(pacc), B, max_pages * P, Hkv, g, scale,
               /*window=*/0, /*ring=*/1, P, n_pages, /*block_k=*/0, chunk,
               n_split, static_cast<cudaStream_t>(stream)};
  return run<true>(D, is_bf16, a);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
