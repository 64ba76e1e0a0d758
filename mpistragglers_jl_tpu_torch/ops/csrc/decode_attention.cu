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
// per row, so the loop walks exactly that range: tiles wholly outside
// it (ring warm-up, the causal frontier, the window's lower edge) are
// never read.
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
// page table), about 4.36 MB, or 1.30 us at 3.35 TB/s; its 34 MFLOP
// are negligible beside that.
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
// * positions (and the page table) come from device memory: no host
//   sync;
// * the kernel allocates nothing and runs on the caller's stream; the
//   C entries return cudaGetLastError() for the wrapper to check.
//
// K7, the attribution variants of benchmarks/decode_kernel_attrib.py
// (`variant(mode)`), is the template's MODE parameter: the same grid,
// 32-key tiles and fetch/stash pair, with only what runs after the
// stash stripped down, so a redesign of K5 carries them along. FULL is
// K5/K6 itself (every other branch below is `if constexpr`). The
// variants walk every key (the reference runs them at pos = L - 1) and
// write f32 (B, H, D); segments are the reference's k-blocks,
// [j*block_k, (j+1)*block_k) cut at L, block_k % 32 == 0, so a tile
// never straddles two:
//   DMA      out[b, 0, 0] = sum_j (k[b, j*bk, 0, 0] + v[b, j*bk, 0, 0])
//   DOT      out[b, h*g+i, 0] = sum_j max_{l in seg j} (q_i . k_l) * scale
//   DEQUANT  the same with s_l * k_s[l, h]
//   NOSM     out[b, h*g+i, :] = sum_l s_l * k_s[l,h] * v_s[l,h] * v_l
// all other entries 0. Every mode stashes the whole tile into shared
// memory before a barrier, so no load is dead even where its values
// are not used: each variant moves what K5 moves, 8.65 MB at the
// bench's shape (B=1, L=16384, Hkv=2, D=128), 2.58 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: warp i owns q row i
constexpr int kTile = 32;      // keys per tile: lane j owns key j
constexpr int kMaxGroup = 8;
constexpr float kNeg = -1e30f;

enum Mode : int { FULL = 0, DMA = 1, DOT = 2, DEQUANT = 3, NOSM = 4 };

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

// Dense: pt == nullptr, P and n_pages unused. Paged: L == W ==
// max_pages * P, ring == 1, window == 0. block_k is read by the K7
// modes only; they read neither pos, window nor ring.
template <typename T, int DV, bool PAGED, int MODE>
__global__ void __launch_bounds__(kThreads)
    decode_attention_int8_kernel(const T* __restrict__ q,
                                 const int8_t* __restrict__ k,
                                 const int8_t* __restrict__ v,
                                 const float* __restrict__ ks,
                                 const float* __restrict__ vs,
                                 const int* __restrict__ pos,
                                 const int* __restrict__ pt,
                                 typename OutT<MODE, T>::type* __restrict__ out,
                                 int L, int Hkv, int g, float scale,
                                 int window, int ring, int P, int n_pages,
                                 int block_k) {
  constexpr int D = DV * 128;
  constexpr int KS = D + 4;   // padded K row stride, in floats
  constexpr int CH = D / 16;  // 16-byte chunks per cache row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kMaxGroup][D]
  float* Ks = Qs + kMaxGroup * D;               // [kTile][KS]
  float* Vs = Ks + kTile * KS;                  // [kTile][D]
  float* Ss = Vs + kTile * D;                   // k_s[kTile], v_s[kTile]
  int* Pt = reinterpret_cast<int*>(Ss + 2 * kTile);  // [max_pages], paged

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hkv * g;

  // this row's visible key range (the K7 modes see every key)
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
  const int n_tiles = hi >= lo ? (hi - lo) / kTile + 1 : 0;

  const T* qb = q + ((size_t)b * H + (size_t)h * g) * D;
  for (int e = tid; e < g * D; e += kThreads) Qs[e] = to_f32(qb[e]);
  if (PAGED) {
    const int max_pages = L / P;
    const int* ptb = pt + (size_t)b * max_pages;
    for (int e = tid; e < max_pages; e += kThreads) Pt[e] = ptb[e];
    __syncthreads();  // the first fetch below reads Pt
  }

  // cache row of key slot t (t <= hi), or -1 when its page lies
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

  int4 kr[DV], vr[DV];
  float sr = 0.f;
  // global -> registers for the tile starting at key `base`
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < DV; ++u) {
      const int c = tid + kThreads * u;
      const int r = c / CH, col = (c % CH) * 16;
      const int t = base + r;
      const long long cr = t <= hi ? cache_row(t) : -1ll;
      if (cr >= 0) {
        kr[u] = *reinterpret_cast<const int4*>(kh + cr * row + col);
        vr[u] = *reinterpret_cast<const int4*>(vh + cr * row + col);
      } else {
        kr[u] = make_int4(0, 0, 0, 0);
        vr[u] = make_int4(0, 0, 0, 0);
      }
    }
    if (tid < 2 * kTile) {
      const int t = base + (tid & (kTile - 1));
      const long long cr = t <= hi ? cache_row(t) : -1ll;
      sr = cr >= 0 ? (tid < kTile ? ksh : vsh)[cr * Hkv] : 0.f;
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
  float seg = 0.f;  // K7 DMA, DOT, DEQUANT: the sum over closed segments
  float acc[4 * DV];
#pragma unroll
  for (int c = 0; c < 4 * DV; ++c) acc[c] = 0.f;

  // acc += sum_j pv_j * V[j, this lane's columns], pv_j held by lane j
  auto accumulate_pv = [&](float pv) {
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
  };

  if (n_tiles > 0) fetch(lo);
  for (int it = 0; it < n_tiles; ++it) {
    const int base = lo + it * kTile;
    __syncthreads();  // Qs written / previous tile fully consumed
    stash();
    __syncthreads();
    if (it + 1 < n_tiles) fetch(base + kTile);  // in flight meanwhile
    if constexpr (MODE == DMA) {
      // the reference's acc[0, 0] += k[0, 0] + v[0, 0] per k-block: the
      // segment's first key, kv head 0, column 0
      if (tid == 0 && h == 0 && base % block_k == 0) seg += Ks[0] + Vs[0];
    } else if (warp < g) {
      const bool valid = base + lane <= hi && cache_row(base + lane) >= 0;
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
      if constexpr (MODE == FULL) {
        const float s = ((d0 + d1) + (d2 + d3)) * scale * Ss[lane];
        const float m_new = fmaxf(m, warp_max(valid ? s : kNeg));
        const float pj = valid ? expf(s - m_new) : 0.f;
        const float corr = expf(m - m_new);
        l = l * corr + warp_sum(pj);
        m = m_new;
        const float pv = pj * Ss[kTile + lane];
#pragma unroll
        for (int c = 0; c < 4 * DV; ++c) acc[c] *= corr;
        accumulate_pv(pv);
      } else if constexpr (MODE == NOSM) {
        const float s = ((d0 + d1) + (d2 + d3)) * scale * Ss[lane];
        accumulate_pv(valid ? s * Ss[kTile + lane] : 0.f);
      } else {  // DOT, DEQUANT: a running max, closed with its segment
        float s = ((d0 + d1) + (d2 + d3)) * scale;
        if constexpr (MODE == DEQUANT) s *= Ss[lane];
        m = fmaxf(m, warp_max(valid ? s : kNeg));
        const int next = base + kTile;
        if (next % block_k == 0 || next > hi) {
          seg += m;
          m = kNeg;
        }
      }
    }
  }

  if (warp < g) {
    typename OutT<MODE, T>::type* ob =
        out + ((size_t)b * H + (size_t)h * g + warp) * D;
    if constexpr (MODE == FULL) {
      const float den = fmaxf(l, 1e-20f);
#pragma unroll
      for (int u = 0; u < DV; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          put(ob + u * 128 + lane * 4 + c, acc[4 * u + c] / den);
      }
    } else {
#pragma unroll
      for (int u = 0; u < DV; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = u * 128 + lane * 4 + c;
          // DMA: seg is nonzero in thread 0 of block h == 0 only
          ob[col] = MODE == NOSM ? acc[4 * u + c] : (col == 0 ? seg : 0.f);
        }
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pos, *pt;
  void* out;
  int B, L, Hkv, g;
  float scale;
  int window, ring, P, n_pages, block_k;
  cudaStream_t stream;
};

template <typename T, int DV, bool PAGED, int MODE>
cudaError_t launch(const Args& a) {
  constexpr int D = DV * 128;
  const size_t smem =
      sizeof(float) * (kMaxGroup * D + kTile * (D + 4) + kTile * D + 2 * kTile)
      + (PAGED ? sizeof(int) * (size_t)(a.L / a.P) : 0);
  auto kern = decode_attention_int8_kernel<T, DV, PAGED, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.Hkv, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const int8_t*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.pt),
      static_cast<typename OutT<MODE, T>::type*>(a.out), a.L, a.Hkv, a.g,
      a.scale, a.window, a.ring, a.P, a.n_pages, a.block_k);
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
  if (a.g < 1 || a.g > kMaxGroup || a.B < 1 || a.L < 1 || a.Hkv < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16, PAGED, MODE>(D, a)
                       : dispatch<float, PAGED, MODE>(D, a));
}

}  // namespace

// K5. q (B, 1, Hkv*g, D) f32 or bf16; k, v (B, L, Hkv, D) int8; ks, vs
// (B, L, Hkv) f32; pos (B,) int32; out like q. All contiguous, all on
// the current device. window <= 0 means no window. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int k5_decode_attention_int8(const void* q, const void* k,
                                        const void* v, const void* ks,
                                        const void* vs, const void* pos,
                                        void* out, int B, int L, int Hkv,
                                        int g, int D, float scale, int window,
                                        int ring, int is_bf16, void* stream) {
  const Args a{q, k, v, ks, vs, pos, /*pt=*/nullptr, out,
               B, L, Hkv, g, scale, window, ring, /*P=*/1, /*n_pages=*/0,
               /*block_k=*/0, static_cast<cudaStream_t>(stream)};
  return run<false>(D, is_bf16, a);
}

// K7, positional layout, every key visible. mode 1 DMA, 2 DOT,
// 3 DEQUANT, 4 NOSM (the header note gives each function). q
// (B, 1, Hkv*g, D) f32 or bf16; k, v (B, L, Hkv, D) int8; ks, vs
// (B, L, Hkv) f32; out (B, Hkv*g, D) f32. block_k > 0, a multiple of
// 32. Returns the CUDA error code of the launch.
extern "C" int k7_decode_attention_attrib(int mode, int block_k,
                                          const void* q, const void* k,
                                          const void* v, const void* ks,
                                          const void* vs, void* out, int B,
                                          int L, int Hkv, int g, int D,
                                          float scale, int is_bf16,
                                          void* stream) {
  if (block_k < kTile || block_k % kTile != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, ks, vs, /*pos=*/nullptr, /*pt=*/nullptr, out,
               B, L, Hkv, g, scale, /*window=*/0, /*ring=*/0, /*P=*/1,
               /*n_pages=*/0, block_k, static_cast<cudaStream_t>(stream)};
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
// on the current device. Returns the CUDA error code of the launch.
extern "C" int k6_paged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pos, const void* pt, void* out, int B,
    int max_pages, int P, int n_pages, int Hkv, int g, int D, float scale,
    int is_bf16, void* stream) {
  if (P < 1 || max_pages < 1 || n_pages < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, ks, vs, pos, pt, out,
               B, /*L=*/max_pages * P, Hkv, g, scale, /*window=*/0,
               /*ring=*/1, P, n_pages, /*block_k=*/0,
               static_cast<cudaStream_t>(stream)};
  return run<true>(D, is_bf16, a);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
