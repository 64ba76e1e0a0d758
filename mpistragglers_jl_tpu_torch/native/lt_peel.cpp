// LT (Luby transform) peeling decoder over real-valued blocks.
//
// The host-side hot path of LT-coded GEMM decode (ops/lt.py): given m
// arrived coded shards — each the real-field sum of a few source blocks
// — repeatedly release degree-1 shards and subtract the resolved block
// from every other shard containing it, until all k source blocks are
// recovered. The graph schedule is tiny; the cost is the block
// subtractions, which here run as a single in-place C pass per release
// (the NumPy fallback in ops/lt.py allocates and re-walks Python-side
// per release). The reference has no coding layer at all (SURVEY §2);
// this is north-star capability, and the native layer exists because
// decode latency sits on the coordinator's critical path between
// "enough shards fresh" and "product available".
//
// Inputs use a CSR layout for shard supports: shard r's source-block
// ids are sup[off[r] .. off[r+1]). Shard data is modified IN PLACE.
// Returns the number of resolved source blocks (k on success; < k means
// peeling stalled — callers gate on the decodability predicate, so a
// stall is caller error, reported not crashed).
//
// Build: g++ -O3 -shared -fPIC (native/__init__.py); consumed via
// ctypes from ops/lt.py. No external dependencies.

#include <cstdint>
#include <vector>

namespace {

template <typename T>
long peel(int m, int k, long block_elems, const int32_t* sup,
          const int32_t* off, T* shards, T* out, uint8_t* resolved) {
    // live degree per shard; inverted index block -> shards holding it
    std::vector<int> degree(m);
    std::vector<std::vector<int>> holders(k);
    for (int r = 0; r < m; ++r) {
        degree[r] = static_cast<int>(off[r + 1] - off[r]);
        for (int32_t p = off[r]; p < off[r + 1]; ++p)
            holders[sup[p]].push_back(r);
    }
    // a block is "live in shard r" iff not yet subtracted; track with a
    // per-shard bitmap over its own support via a resolved-block flag:
    // subtraction happens exactly once per (shard, block) because a
    // block resolves once and we subtract from all holders right then.
    std::vector<int> stack;
    for (int r = 0; r < m; ++r)
        if (degree[r] == 1) stack.push_back(r);

    long nresolved = 0;
    std::vector<uint8_t> consumed(m, 0);  // shard already released
    while (!stack.empty() && nresolved < k) {
        int r = stack.back();
        stack.pop_back();
        if (consumed[r] || degree[r] != 1) continue;
        // find the single live block of shard r
        int j = -1;
        for (int32_t p = off[r]; p < off[r + 1]; ++p)
            if (!resolved[sup[p]]) { j = sup[p]; break; }
        if (j < 0) continue;  // all its blocks resolved elsewhere
        consumed[r] = 1;
        resolved[j] = 1;
        ++nresolved;
        T* oj = out + static_cast<long>(j) * block_elems;
        const T* sr = shards + static_cast<long>(r) * block_elems;
        for (long e = 0; e < block_elems; ++e) oj[e] = sr[e];
        // release: subtract block j from every shard holding it
        for (int r2 : holders[j]) {
            if (r2 == r) { --degree[r]; continue; }
            T* s2 = shards + static_cast<long>(r2) * block_elems;
            for (long e = 0; e < block_elems; ++e) s2[e] -= oj[e];
            if (--degree[r2] == 1 && !consumed[r2]) stack.push_back(r2);
        }
    }
    return nresolved;
}

}  // namespace

extern "C" {

long lt_peel_f32(int m, int k, long block_elems, const int32_t* sup,
                 const int32_t* off, float* shards, float* out,
                 uint8_t* resolved) {
    return peel<float>(m, k, block_elems, sup, off, shards, out, resolved);
}

long lt_peel_f64(int m, int k, long block_elems, const int32_t* sup,
                 const int32_t* off, double* shards, double* out,
                 uint8_t* resolved) {
    return peel<double>(m, k, block_elems, sup, off, shards, out, resolved);
}

}  // extern "C"
