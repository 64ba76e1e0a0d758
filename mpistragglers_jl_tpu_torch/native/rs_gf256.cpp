// Systematic Cauchy Reed-Solomon erasure codec over GF(2^8).
//
// The float-field MDS code in ops/coding.py is the device compute path
// (encode/decode are matmuls on the card) but is only numerically exact; this
// codec is the byte-exact companion for arbitrary host-side payloads —
// checkpoint shards, serialized buffers, control messages — where
// bit-identical recovery is required. The reference has no coding layer
// at all (its payloads are raw bytes over MPI, reference
// src/MPIAsyncPools.jl:82-84); this is north-star capability.
//
// Construction: generator G = [I_k ; P] (n x k) with P the Cauchy matrix
// P[i][j] = 1/(x_i ^ y_j), x_i = k+i, y_j = j over GF(256) with the
// AES-adjacent primitive polynomial 0x11D. Every square submatrix of a
// Cauchy matrix is nonsingular, so [I ; P] is MDS: any k of the n coded
// rows reconstruct the k source rows exactly (the property the pool's
// repochs arrival mask selects shards by).
//
// Build: g++ -O3 -shared -fPIC (driven by native/__init__.py); consumed
// via ctypes from utils/rs_gf256.py. No external dependencies.

#include <cstdint>
#include <cstring>

namespace {

uint8_t GF_EXP[512];
uint8_t GF_LOG[256];
// full 256x256 product table: one L1-resident lookup per byte in the
// row-update inner loop below
uint8_t GF_MUL[256][256];

struct TableInit {
    TableInit() {
        // generator 2 is primitive for 0x11D
        int x = 1;
        for (int i = 0; i < 255; ++i) {
            GF_EXP[i] = static_cast<uint8_t>(x);
            GF_LOG[x] = static_cast<uint8_t>(i);
            x <<= 1;
            if (x & 0x100) x ^= 0x11D;
        }
        for (int i = 255; i < 512; ++i) GF_EXP[i] = GF_EXP[i - 255];
        GF_LOG[0] = 0;  // log(0) undefined; guarded at use sites
        for (int a = 0; a < 256; ++a) {
            GF_MUL[0][a] = 0;
            GF_MUL[a][0] = 0;
        }
        for (int a = 1; a < 256; ++a)
            for (int b = 1; b < 256; ++b)
                GF_MUL[a][b] = GF_EXP[GF_LOG[a] + GF_LOG[b]];
    }
} table_init;

inline uint8_t gf_mul(uint8_t a, uint8_t b) { return GF_MUL[a][b]; }

inline uint8_t gf_inv(uint8_t a) {
    // a != 0 required
    return GF_EXP[255 - GF_LOG[a]];
}

// out[len] ^= c * src[len] — the codec's hot loop. With -O3 the
// per-byte table lookup sustains ~1 GB/s; payloads here are control-
// plane sized (checkpoints, messages), not the device data path.
inline void addmul_row(uint8_t* out, const uint8_t* src, uint8_t c,
                       long len) {
    if (c == 0) return;
    const uint8_t* mul = GF_MUL[c];
    if (c == 1) {
        for (long i = 0; i < len; ++i) out[i] ^= src[i];
        return;
    }
    for (long i = 0; i < len; ++i) out[i] ^= mul[src[i]];
}

}  // namespace

extern "C" {

// Fill G (n*k, row-major) with the systematic Cauchy generator.
// Returns 0, or -1 if the construction is out of range (n > 256 or
// k <= 0 or k > n).
int rs_make_generator(int n, int k, uint8_t* G) {
    if (k <= 0 || n < k || n > 256) return -1;
    std::memset(G, 0, static_cast<size_t>(n) * k);
    for (int j = 0; j < k; ++j) G[j * k + j] = 1;  // I_k
    for (int i = 0; i < n - k; ++i) {
        for (int j = 0; j < k; ++j) {
            uint8_t x = static_cast<uint8_t>(k + i);
            uint8_t y = static_cast<uint8_t>(j);
            G[(k + i) * k + j] = gf_inv(x ^ y);  // x != y since x >= k > j
        }
    }
    return 0;
}

// out (rows*len) = M (rows*k) * data (k*len) over GF(256).
int rs_matmul(const uint8_t* M, int rows, int k, const uint8_t* data,
              uint8_t* out, long len) {
    if (rows <= 0 || k <= 0 || len < 0) return -1;
    std::memset(out, 0, static_cast<size_t>(rows) * len);
    for (int i = 0; i < rows; ++i)
        for (int j = 0; j < k; ++j)
            addmul_row(out + static_cast<size_t>(i) * len,
                       data + static_cast<size_t>(j) * len, M[i * k + j],
                       len);
    return 0;
}

// Invert a k x k matrix over GF(256) (Gauss-Jordan with partial pivot
// by nonzero search). Returns 0, or -1 if singular.
int rs_invert(const uint8_t* A, int k, uint8_t* Ainv) {
    if (k <= 0 || k > 256) return -1;
    // augmented [work | inv] on the stack-free heap-lite path: k <= 256
    uint8_t work[256][256];
    for (int i = 0; i < k; ++i) {
        std::memcpy(work[i], A + static_cast<size_t>(i) * k, k);
        std::memset(Ainv + static_cast<size_t>(i) * k, 0, k);
        Ainv[static_cast<size_t>(i) * k + i] = 1;
    }
    for (int col = 0; col < k; ++col) {
        int piv = -1;
        for (int r = col; r < k; ++r)
            if (work[r][col] != 0) { piv = r; break; }
        if (piv < 0) return -1;
        if (piv != col) {
            for (int j = 0; j < k; ++j) {
                uint8_t t = work[col][j];
                work[col][j] = work[piv][j];
                work[piv][j] = t;
                t = Ainv[static_cast<size_t>(col) * k + j];
                Ainv[static_cast<size_t>(col) * k + j] =
                    Ainv[static_cast<size_t>(piv) * k + j];
                Ainv[static_cast<size_t>(piv) * k + j] = t;
            }
        }
        uint8_t inv_p = gf_inv(work[col][col]);
        for (int j = 0; j < k; ++j) {
            work[col][j] = gf_mul(work[col][j], inv_p);
            Ainv[static_cast<size_t>(col) * k + j] =
                gf_mul(Ainv[static_cast<size_t>(col) * k + j], inv_p);
        }
        for (int r = 0; r < k; ++r) {
            if (r == col) continue;
            uint8_t c = work[r][col];
            if (c == 0) continue;
            for (int j = 0; j < k; ++j) {
                work[r][j] = static_cast<uint8_t>(
                    work[r][j] ^ gf_mul(c, work[col][j]));
                Ainv[static_cast<size_t>(r) * k + j] = static_cast<uint8_t>(
                    Ainv[static_cast<size_t>(r) * k + j] ^
                    gf_mul(c, Ainv[static_cast<size_t>(col) * k + j]));
            }
        }
    }
    return 0;
}

// Encode: data (k*len) -> coded (n*len) using generator G (n*k).
int rs_encode(int n, int k, const uint8_t* G, const uint8_t* data,
              uint8_t* coded, long len) {
    return rs_matmul(G, n, k, data, coded, len);
}

// Decode: shards (k*len) carrying coded rows indices[0..k-1] -> source
// (k*len). Returns 0; -1 on bad args; -2 if the index set is not
// invertible (cannot happen for distinct indices of an MDS generator,
// but guarded for caller-supplied G).
int rs_decode(int n, int k, const uint8_t* G, const int32_t* indices,
              const uint8_t* shards, uint8_t* out, long len) {
    if (k <= 0 || k > 256 || n < k || n > 256 || len < 0) return -1;
    uint8_t sub[256 * 256];
    for (int i = 0; i < k; ++i) {
        int32_t idx = indices[i];
        if (idx < 0 || idx >= n) return -1;
        std::memcpy(sub + static_cast<size_t>(i) * k,
                    G + static_cast<size_t>(idx) * k, k);
    }
    uint8_t inv[256 * 256];
    if (rs_invert(sub, k, inv) != 0) return -2;
    return rs_matmul(inv, k, k, shards, out, len);
}

}  // extern "C"
