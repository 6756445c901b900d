// kmermatcher post-extraction pipeline in one native pass:
//   global entry sort -> group/centre assignment -> pair sort ->
//   per-(centre,member) best-diagonal scan -> prefilter rows.
//
// This is the host-side equivalent of the reference's sort+assignGroup+
// writeKmerMatcherResult chain (lib/mmseqs/src/linclust/kmermatcher.cpp:
// 409-563, 815-930), fused so no intermediate table is materialised in
// NumPy (the Python assign_groups path allocates a dozen n-sized int64
// temporaries — at 32M entries that dominates the whole stage).
// Semantics are bit-identical to kmer/matcher.py's assign_groups +
// _build_pref_db_python (oracle-tested there against the C++ reference).
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Stable LSD radix sort of (key, payload) by 16-bit digits, skipping
// passes whose digit is constant across the array (e.g. the always-set
// bit-63 digit of canonical k-mer fields).  Stability is what lets the
// scan below reproduce np.lexsort's (key, tie, pos) total order with a
// key-only sort + tiny per-group tie sorts: equal keys keep emission
// order.  ~3 effective passes for 44-bit k-mer keys vs a comparison
// sort's ~22 on multi-word structs — the entry sort drops from the
// stage's dominant cost to noise.
struct RadixScratch {
    std::vector<uint64_t> kbuf;
    std::vector<uint32_t> pbuf;
};

void radix_sort_u64_u32(std::vector<uint64_t> &keys,
                        std::vector<uint32_t> &payload,
                        RadixScratch &scratch, int passes = 4) {
    const int64_t n = (int64_t)keys.size();
    if (n < 2) return;
    scratch.kbuf.resize(n);
    scratch.pbuf.resize(n);
    uint64_t *k_src = keys.data(), *k_dst = scratch.kbuf.data();
    uint32_t *p_src = payload.data(), *p_dst = scratch.pbuf.data();
    int n_chunks = 1;
#ifdef _OPENMP
    if (n > (1 << 18)) {
        n_chunks = omp_get_max_threads();
        if (n_chunks > 8) n_chunks = 8;
    }
#endif
    // Digit width adapts to the table size: 16-bit digits (65536 open
    // write streams) are fastest while the table fits the cache/TLB
    // reach, but thrash the TLB on multi-GB tables (the 5M-read scale
    // ran the scatter ~4x slower per element than the 120k scale);
    // 8-bit digits keep 256 streams and scale flat.
    const int digit_bits = n > (48 << 20) ? 8 : 16;
    const int n_buckets = 1 << digit_bits;
    const uint64_t digit_mask = (uint64_t)n_buckets - 1;
    const int total_passes =
        (passes * 16 + digit_bits - 1) / digit_bits;
    // per-(chunk, digit) histograms; stable parallel scatter: global
    // position = digits before mine + same-digit items in earlier chunks
    std::vector<int64_t> hists((size_t)n_chunks * n_buckets);
    for (int pass = 0; pass < total_passes; pass++) {
        const int shift = pass * digit_bits;
        std::memset(hists.data(), 0,
                    (size_t)n_chunks * n_buckets * sizeof(int64_t));
#pragma omp parallel for schedule(static, 1)
        for (int t = 0; t < n_chunks; t++) {
            int64_t *h = hists.data() + (size_t)t * n_buckets;
            const int64_t lo = n * t / n_chunks,
                          hi = n * (t + 1) / n_chunks;
            for (int64_t i = lo; i < hi; i++)
                h[(k_src[i] >> shift) & digit_mask]++;
        }
        bool constant = false;
        {
            const int d0 = (int)((k_src[0] >> shift) & digit_mask);
            int64_t tot = 0;
            for (int t = 0; t < n_chunks; t++)
                tot += hists[(size_t)t * n_buckets + d0];
            constant = tot == n;
        }
        if (constant) continue;
        int64_t run = 0;
        for (int d = 0; d < n_buckets; d++)
            for (int t = 0; t < n_chunks; t++) {
                int64_t &h = hists[(size_t)t * n_buckets + d];
                const int64_t c = h;
                h = run;
                run += c;
            }
#pragma omp parallel for schedule(static, 1)
        for (int t = 0; t < n_chunks; t++) {
            int64_t *h = hists.data() + (size_t)t * n_buckets;
            const int64_t lo = n * t / n_chunks,
                          hi = n * (t + 1) / n_chunks;
            for (int64_t i = lo; i < hi; i++) {
                const int64_t j = h[(k_src[i] >> shift) & digit_mask]++;
                k_dst[j] = k_src[i];
                p_dst[j] = p_src[i];
            }
        }
        std::swap(k_src, k_dst);
        std::swap(p_src, p_dst);
    }
    if (k_src != keys.data()) {
        std::memcpy(keys.data(), k_src, n * sizeof(uint64_t));
        std::memcpy(payload.data(), p_src, n * sizeof(uint32_t));
    }
}

inline bool can_cover(int cov_mode, float cov_thr, float ql, float tl) {
    if (cov_thr <= 0.0f) return true;
    switch (cov_mode) {
        case 0: return (ql / tl >= cov_thr) && (tl / ql >= cov_thr);
        case 1: return ql / tl >= cov_thr;
        case 2: return tl / ql >= cov_thr;
        case 3: return (tl / ql >= cov_thr) && (tl / ql <= 1.0f);
        case 4: return (ql / tl >= cov_thr) && (ql / tl <= 1.0f);
        case 5: {
            const float mn = ql < tl ? ql : tl, mx = ql < tl ? tl : ql;
            return mn / mx >= cov_thr;
        }
        default: return true;
    }
}

}  // namespace

extern "C" {

// declared in host_kernels.cpp
int64_t build_pref_scan(
    const int64_t *c, const uint8_t *f, const int64_t *m, const int32_t *d,
    int64_t n, const uint32_t *keys,
    uint32_t *qkey_o, uint32_t *tkey_o, int32_t *score_o, int32_t *diag_o,
    int64_t *group_row_start, int64_t *group_centre, int64_t *n_groups_o);

// Phase 1 of the kmermatcher scan: sorted-group walk + pair emission
// (assignGroup, kmermatcher.cpp:453-562).  Emits (centre<<32|member,
// diag^bias, fwd) rows into caller buffers (capacity n suffices: every
// entry emits at most one row).  Deterministic for a given entry
// MULTISET regardless of input order — the radix orders groups by kmer
// and the per-group (tie, pos) sort fixes intra-group order — so
// distributed ranks can run it over disjoint kmer ranges and
// concatenate in kmer-range order to reproduce the single-process pair
// stream exactly.
int64_t kmer_emit_pairs(
    const uint64_t *kmer, const int64_t *id, const int32_t *pos,
    const int32_t *seq_len, int64_t n,
    int64_t include_only_extendable, int64_t cov_mode, float cov_thr,
    uint64_t *pk1_o, uint32_t *pk2_o, uint8_t *pfwd_o)
{
    const bool timing = std::getenv("CARPEDEAM_SCAN_TIMING") != nullptr;
    auto tick = std::chrono::steady_clock::now();
    auto lap = [&](const char *label) {
        if (!timing) return;
        auto now = std::chrono::steady_clock::now();
        std::fprintf(stderr, "scan %s: %.2fs\n", label,
                     std::chrono::duration<double>(now - tick).count());
        tick = now;
    };
    // ---- global sort (kmermatcher.cpp:409-415) -------------------------
    // Key-only stable radix; the (tie, pos) order the reference realises
    // with a full multi-word comparison sort only matters WITHIN an
    // equal-key group (rep selection + emission order), so it is applied
    // there with tiny per-group sorts instead.  The resulting total order
    // is exactly np.lexsort((pos, tie, key)) -- the Python oracle's.
    // persistent grow-only buffers (first-touch page faults cost ~14s/GB
    // on the measurement VM; per-call allocation dominated 5M-scale runs).
    // Single-caller contract: the Python layer serialises scan calls.
    static std::vector<uint64_t> ekey;
    static std::vector<uint32_t> eidx;
    ekey.resize(n);
    eidx.resize(n);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        ekey[i] = kmer[i] | (1ull << 63);
        eidx[i] = (uint32_t)i;
    }
    {
        static RadixScratch scratch;
        radix_sort_u64_u32(ekey, eidx, scratch);
    }

    lap("entry radix");
    // ---- assignGroup (kmermatcher.cpp:453-562) -------------------------
    // centre = (tie, pos)-first entry of each equal-key group; singleton
    // groups drop; every kept entry (incl. the rep's own) becomes a pair
    // row.  Group walk parallelised by splitting the sorted range at
    // group boundaries; per-thread emission vectors concatenate in order.
    auto tie_of = [&](int64_t i) -> uint64_t {
        return ((uint64_t)(0xFFFFFF - (uint32_t)seq_len[i]) << 40) |
               (uint64_t)id[i];
    };
    int n_chunks = 1;
#ifdef _OPENMP
    n_chunks = omp_get_max_threads();
    if (n_chunks > 8) n_chunks = 8;
    if (n < (1 << 16)) n_chunks = 1;
#endif
    std::vector<int64_t> chunk_lo(n_chunks + 1, n);
    chunk_lo[0] = 0;
    for (int t = 1; t < n_chunks; t++) {
        int64_t b = n * t / n_chunks;
        while (b < n && b > 0 && ekey[b] == ekey[b - 1]) b++;
        chunk_lo[t] = b;
    }
    struct Emit {
        std::vector<uint64_t> k1;
        std::vector<uint32_t> k2;
        std::vector<uint8_t> fwd;
    };
    static std::vector<Emit> emits;
    emits.resize(n_chunks);
#pragma omp parallel for schedule(static, 1)
    for (int t = 0; t < n_chunks; t++) {
        Emit &em = emits[t];
        em.k1.reserve((size_t)(chunk_lo[t + 1] - chunk_lo[t]));
        std::vector<std::pair<uint64_t, int64_t>> grp;  // (tie, orig row)
        int64_t g0 = chunk_lo[t];
        auto emit_one = [&](Emit &em_, int64_t rep, bool rep_is_rev,
                            int64_t rep_len, int64_t e) {
            const bool tgt_is_rev = (kmer[e] >> 63) == 0;
            const int64_t t_len = seq_len[e];
            const int64_t q_pos =
                tgt_is_rev ? rep_len - 1 - pos[rep] : pos[rep];
            const int64_t t_pos_adj =
                tgt_is_rev ? t_len - 1 - pos[e] : pos[e];
            const int64_t diagonal = q_pos - t_pos_adj;
            bool keep;
            if (include_only_extendable) {
                keep = (diagonal < 0) || (diagonal > rep_len - t_len);
            } else {
                keep = can_cover((int)cov_mode, cov_thr,
                                 (float)rep_len, (float)t_len);
            }
            if (!keep) return;
            em_.k1.push_back(((uint64_t)(uint32_t)id[rep] << 32) |
                             (uint64_t)(uint32_t)id[e]);
            em_.k2.push_back((uint32_t)(int32_t)diagonal ^ 0x80000000u);
            em_.fwd.push_back((uint8_t)(!(rep_is_rev ^ tgt_is_rev)));
        };
        while (g0 < chunk_lo[t + 1]) {
            int64_t g1 = g0 + 1;
            while (g1 < n && ekey[g1] == ekey[g0]) g1++;
            if (g1 - g0 == 2) {
                // dominant case: pair group — order by (tie, pos)
                // without the vector + sort machinery
                int64_t a = (int64_t)eidx[g0], b = (int64_t)eidx[g0 + 1];
                const uint64_t ta = tie_of(a), tb = tie_of(b);
                if (tb < ta || (tb == ta && pos[b] < pos[a]))
                    std::swap(a, b);
                const bool rep_is_rev = (kmer[a] >> 63) == 0;
                const int64_t rep_len = seq_len[a];
                emit_one(em, a, rep_is_rev, rep_len, a);
                emit_one(em, a, rep_is_rev, rep_len, b);
            } else if (g1 - g0 > 2) {
                grp.clear();
                for (int64_t i = g0; i < g1; i++)
                    grp.emplace_back(tie_of(eidx[i]), (int64_t)eidx[i]);
                std::sort(grp.begin(), grp.end(),
                          [&](const std::pair<uint64_t, int64_t> &a,
                              const std::pair<uint64_t, int64_t> &b) {
                              if (a.first != b.first) return a.first < b.first;
                              return pos[a.second] < pos[b.second];
                          });
                const int64_t rep = grp[0].second;
                const bool rep_is_rev = (kmer[rep] >> 63) == 0;
                const int64_t rep_len = seq_len[rep];
                for (size_t gi = 0; gi < grp.size(); gi++)
                    emit_one(em, rep, rep_is_rev, rep_len,
                             grp[gi].second);
            }
            g0 = g1;
        }
    }
    // (ekey/eidx keep their capacity for the next call)
    int64_t np = 0;
    for (int t = 0; t < n_chunks; t++) np += (int64_t)emits[t].k1.size();
    {
        int64_t off = 0;
        for (int t = 0; t < n_chunks; t++) {
            const int64_t cn = (int64_t)emits[t].k1.size();
            std::memcpy(pk1_o + off, emits[t].k1.data(),
                        cn * sizeof(uint64_t));
            std::memcpy(pk2_o + off, emits[t].k2.data(),
                        cn * sizeof(uint32_t));
            std::memcpy(pfwd_o + off, emits[t].fwd.data(), (size_t)cn);
            off += cn;
            emits[t].k1.clear();      // keep capacity
            emits[t].k2.clear();
            emits[t].fwd.clear();
        }
    }
    lap("group walk + emit");
    return np;
}

// Phase 2: sort the pair stream by (centre, member, diag) — stable, so
// the caller-provided order breaks ties exactly like the fused
// single-process scan — and run the writeKmerMatcherResult scan.
int64_t kmer_pairs_to_pref(
    const uint64_t *pk1, const uint32_t *pk2, const uint8_t *pfwd,
    int64_t np, const uint32_t *keys,
    uint32_t *qkey_o, uint32_t *tkey_o, int32_t *score_o, int32_t *diag_o,
    int64_t *group_row_start, int64_t *group_centre, int64_t *n_groups_o)
{
    const bool timing = std::getenv("CARPEDEAM_SCAN_TIMING") != nullptr;
    auto tick = std::chrono::steady_clock::now();
    auto lap = [&](const char *label) {
        if (!timing) return;
        auto now = std::chrono::steady_clock::now();
        std::fprintf(stderr, "scan %s: %.2fs\n", label,
                     std::chrono::duration<double>(now - tick).count());
        tick = now;
    };
    // ---- sort pairs by (centre, member, diag) --------------------------
    // The three fields almost always pack into ONE <=64-bit key
    // (ids < n_seqs, diag range set by sequence lengths), so one stable
    // radix of ceil(bits/16) passes replaces the generic 6-pass
    // two-stage compose; order is (centre, member, diag) lexicographic
    // with emission order preserved on ties either way.
    static std::vector<uint32_t> pidx;
    pidx.resize(np);
    {
        uint64_t max_c = 0, max_m = 0;
        uint32_t min_k2 = 0xFFFFFFFFu, max_k2 = 0;
        for (int64_t i = 0; i < np; i++) {
            const uint64_t c = pk1[i] >> 32, m = pk1[i] & 0xFFFFFFFFull;
            if (c > max_c) max_c = c;
            if (m > max_m) max_m = m;
            if (pk2[i] < min_k2) min_k2 = pk2[i];
            if (pk2[i] > max_k2) max_k2 = pk2[i];
        }
        auto bits_of = [](uint64_t v) -> int {
            return v ? 64 - __builtin_clzll(v) : 0;
        };
        const int bc = bits_of(max_c), bm = bits_of(max_m),
                  bd = bits_of((uint64_t)(max_k2 - min_k2));
        static RadixScratch scratch;
        static std::vector<uint64_t> skey;
        skey.resize(np);
        if (np && bc + bm + bd <= 64) {
            const int passes = (bc + bm + bd + 15) / 16;
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < np; i++) {
                skey[i] = ((pk1[i] >> 32) << (bm + bd)) |
                          ((pk1[i] & 0xFFFFFFFFull) << bd) |
                          (uint64_t)(pk2[i] - min_k2);
                pidx[i] = (uint32_t)i;
            }
            radix_sort_u64_u32(skey, pidx, scratch,
                               passes > 0 ? passes : 1);
        } else {
            for (int64_t i = 0; i < np; i++) {
                skey[i] = pk2[i];
                pidx[i] = (uint32_t)i;
            }
            radix_sort_u64_u32(skey, pidx, scratch, 2);
            for (int64_t i = 0; i < np; i++) skey[i] = pk1[pidx[i]];
            radix_sort_u64_u32(skey, pidx, scratch, 4);
        }
    }

    lap("pair radix");
    // ---- writeKmerMatcherResult scan ------------------------------------
    static std::vector<int64_t> c, m;
    static std::vector<uint8_t> f;
    static std::vector<int32_t> d;
    c.resize(np);
    m.resize(np);
    f.resize(np);
    d.resize(np);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < np; i++) {
        const uint64_t k1 = pk1[pidx[i]];
        c[i] = (int64_t)(k1 >> 32);
        m[i] = (int64_t)(k1 & 0xFFFFFFFFull);
        d[i] = (int32_t)(pk2[pidx[i]] ^ 0x80000000u);
        f[i] = pfwd[pidx[i]];
    }
    lap("column fill");
    const int64_t ret = build_pref_scan(c.data(), f.data(), m.data(), d.data(), np,
                           keys, qkey_o, tkey_o, score_o, diag_o,
                           group_row_start, group_centre, n_groups_o);
    lap("build_pref_scan");
    return ret;
}

// Full post-extraction kmermatcher: returns row count; *n_groups_o like
// build_pref_scan.  Row buffers must hold n + #groups rows (cap 2n + 2).
int64_t kmermatcher_scan(
    const uint64_t *kmer, const int64_t *id, const int32_t *pos,
    const int32_t *seq_len, int64_t n, const uint32_t *keys,
    int64_t include_only_extendable, int64_t cov_mode, float cov_thr,
    uint32_t *qkey_o, uint32_t *tkey_o, int32_t *score_o, int32_t *diag_o,
    int64_t *group_row_start, int64_t *group_centre, int64_t *n_groups_o)
{
    static std::vector<uint64_t> pk1;
    static std::vector<uint32_t> pk2;
    static std::vector<uint8_t> pfwd;
    pk1.resize((size_t)n);
    pk2.resize((size_t)n);
    pfwd.resize((size_t)n);
    const int64_t np = kmer_emit_pairs(
        kmer, id, pos, seq_len, n, include_only_extendable, cov_mode,
        cov_thr, pk1.data(), pk2.data(), pfwd.data());
    return kmer_pairs_to_pref(pk1.data(), pk2.data(), pfwd.data(), np,
                              keys, qkey_o, tkey_o, score_o, diag_o,
                              group_row_start, group_centre, n_groups_o);
}


}  // extern "C"
