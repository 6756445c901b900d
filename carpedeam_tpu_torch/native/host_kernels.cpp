// Native host runtime: per-pair overlap scoring and correction coverage
// accumulation.
//
// These are the host-side (CPU fallback / verification) implementations of
// the two hot batched stages.  The device path (ops/rescore_tpu.py,
// ops/correction_tpu.py) runs the same math as dense XLA kernels on the
// accelerator; this C++ serves hosts without an accelerator at reference
// speed instead of paying NumPy's dense-padded-window materialisation.
// Semantics mirror the reference exactly:
//   - scoring: DistanceCalculator::computeUngappedAlignment, END_TO_END
//     mode (+2/-3 over the full overlap, two ushort diagonal candidates,
//     ties favour the negative candidate; lib/mmseqs/src/alignment/
//     DistanceCalculator.h:93-220, rescorediagonal.cpp:146-270)
//   - correction accumulation: read filters + countDeamCov stacking
//     (src/assembler/correction.cpp:200-392)
//
// OpenMP parallel over pairs/records like the reference's
// `#pragma omp parallel for schedule(dynamic)` loops.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// 5-letter code fold (NucleotideMatrix::setupLetterMapping): A0 C1 T2 G3 X4
struct Tables {
    uint8_t code[256];
    uint8_t revcomp_x[256];   // char -> complement char via "ACTGX" decode
    uint8_t revcomp_n[256];   // char -> complement char via "ACTGN" decode
    uint8_t ry[256];          // purine/pyrimidine class ('C'/'T' -> 1)
    uint8_t acgt[256];        // nucleotideMap (A0 C1 G2 T3, else 0)
    Tables() {
        memset(code, 4, sizeof(code));
        const char *a = "Aa", *c = "CcMmYyHh", *t = "TtUuWw",
                   *g = "GgKkBbDdVvRrSs";
        for (const char *p = a; *p; p++) code[(uint8_t)*p] = 0;
        for (const char *p = c; *p; p++) code[(uint8_t)*p] = 1;
        for (const char *p = t; *p; p++) code[(uint8_t)*p] = 2;
        for (const char *p = g; *p; p++) code[(uint8_t)*p] = 3;
        const char dec_x[6] = "ACTGX";
        const char dec_n[6] = "ACTGN";
        static const uint8_t comp[5] = {2, 3, 0, 1, 4};
        for (int i = 0; i < 256; i++) {
            revcomp_x[i] = (uint8_t)dec_x[comp[code[i]]];
            revcomp_n[i] = (uint8_t)dec_n[comp[code[i]]];
        }
        memset(ry, 0, sizeof(ry));
        ry[(uint8_t)'C'] = 1;
        ry[(uint8_t)'T'] = 1;
        memset(acgt, 0, sizeof(acgt));
        acgt[(uint8_t)'C'] = 1;
        acgt[(uint8_t)'G'] = 2;
        acgt[(uint8_t)'T'] = 3;
    }
};
const Tables T;

inline uint8_t upper(uint8_t b) { return b & 0xDF; }

}  // namespace

extern "C" {

// Score all (query, target, diagonal) candidates end-to-end.
// diag: raw prefilter diagonal (int16-truncated, sign-extended to i32).
// Outputs (per pair): score, qstart, qend, tstart, tend, aln_len, id_cnt.
void score_pairs(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const int32_t *qid, const int32_t *tid, const int32_t *diag,
    const uint8_t *is_rev, int64_t n_pairs,
    int32_t *score_o, int32_t *qstart_o, int32_t *qend_o,
    int32_t *tstart_o, int32_t *tend_o, int32_t *aln_len_o,
    int32_t *id_cnt_o)
{
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t i = 0; i < n_pairs; i++) {
        const int64_t q = qid[i], t = tid[i];
        const int64_t ql = lengths[q], tl = lengths[t];
        const uint8_t *qs = data + offsets[q];
        const uint8_t *ts = data + offsets[t];
        const bool rev = is_rev[i] != 0;
        const int64_t du = (int64_t)((uint32_t)diag[i] & 0xFFFFu);

        // query byte at strand-corrected position p
        auto qbyte = [&](int64_t p) -> uint8_t {
            return rev ? T.revcomp_x[qs[ql - 1 - p]] : qs[p];
        };

        int64_t best_score = 0, best_cand = 0, best_len = 0;
        bool got = false;
        const int64_t cands[2] = {du - 65536, du};
        for (int ci = 0; ci < 2; ci++) {
            const int64_t cand = cands[ci];
            const bool neg = cand < 0;
            const int64_t dist = neg ? -cand : cand;
            const bool valid = neg ? (dist < tl) : (dist < ql);
            if (!valid) continue;
            const int64_t min_len =
                neg ? (tl - dist < ql ? tl - dist : ql)
                    : (tl < ql - dist ? tl : ql - dist);
            const int64_t qoff = neg ? 0 : dist;
            const int64_t toff = neg ? dist : 0;
            int64_t m = 0;
            for (int64_t p = 0; p < min_len; p++) {
                const uint8_t qc = T.code[qbyte(qoff + p)];
                const uint8_t tc = T.code[ts[toff + p]];
                m += (qc == tc && qc < 4);
            }
            int64_t sc = 2 * m - 3 * (min_len - m);
            if (sc < 0) sc = 0;
            if (sc > best_score) {   // strict: ties favour the neg candidate
                best_score = sc;
                best_cand = cand;
                best_len = min_len;
                got = true;
            }
        }

        int64_t start = got ? 0 : -1;
        int64_t end = got ? best_len - 1 : -1;
        const int64_t dist = got ? (best_cand < 0 ? -best_cand : best_cand) : 0;
        const bool dneg = got && best_cand < 0;
        const int64_t qstart = dneg ? start : start + dist;
        const int64_t qend = dneg ? end : end + dist;
        const int64_t tstart = dneg ? start + dist : start;
        const int64_t tend = dneg ? end + dist : end;
        const int64_t aln_len = end - start + 1;

        // NumPy-oracle boundary semantics: indices clip at 0 (so the
        // invalid-hit window [-1,-1] reads the first characters) and
        // positions past the sequence end read the 0 padding byte.
        int64_t idc = 0;
        for (int64_t p = 0; p < aln_len; p++) {
            int64_t qp = qstart + p, tp = tstart + p;
            if (qp < 0) qp = 0;
            if (tp < 0) tp = 0;
            const uint8_t qch = upper(qp < ql ? qbyte(qp) : 0);
            const uint8_t tch = upper(tp < tl ? ts[tp] : 0);
            idc += (qch == tch);
        }

        score_o[i] = (int32_t)best_score;
        qstart_o[i] = (int32_t)qstart;
        qend_o[i] = (int32_t)qend;
        tstart_o[i] = (int32_t)tstart;
        tend_o[i] = (int32_t)tend;
        aln_len_o[i] = (int32_t)aln_len;
        id_cnt_o[i] = (int32_t)idc;
    }
}

// Correction coverage accumulation: per record, RY-identity filter then
// scatter target-base x damage-layer counts onto the query's global
// positions.  counts / rev_counts are (total_len * 44) int32, additive.
void correction_accumulate(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const int32_t *rec_q, const int32_t *rec_t, const uint8_t *rec_is_rev,
    const int32_t *rec_qstart, const int32_t *rec_tstart,
    const int32_t *rec_alen, const uint8_t *rec_keep_pre,
    const int32_t *rec_ry_smin, int64_t n_rec,
    int32_t *counts, int32_t *rev_counts)
{
    // accumulation per record is scatter into a shared array; records of
    // the same query never run concurrently if we parallelise by query --
    // but records are grouped by query in the alignment DB, so chunks of
    // the record range mostly touch disjoint query ranges.  Use atomics.
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t r = 0; r < n_rec; r++) {
        if (!rec_keep_pre[r]) continue;
        const int64_t q = rec_q[r], t = rec_t[r];
        const int64_t tl = lengths[t];
        const uint8_t *qb = data + offsets[q];
        const uint8_t *tb = data + offsets[t];
        const bool rev = rec_is_rev[r] != 0;
        const int64_t qst = rec_qstart[r], tst = rec_tstart[r];
        const int64_t alen = rec_alen[r];

        auto tbyte = [&](int64_t p) -> uint8_t {
            return rev ? T.revcomp_n[tb[tl - 1 - p]] : tb[p];
        };

        int64_t ry_matches = 0;
        for (int64_t p = 0; p < alen; p++)
            ry_matches += (T.ry[qb[qst + p]] == T.ry[tbyte(tst + p)]);
        if (ry_matches < rec_ry_smin[r]) continue;

        const int64_t goff = offsets[q];
        for (int64_t p = 0; p < alen; p++) {
            const int64_t t_real = tst + p;
            const uint8_t tch = tbyte(t_real);
            const int64_t base = T.acgt[tch];
            // layer_index semantics: 5' band, interior 5, 3' band wins on
            // overlap (sequences shorter than 10; nuclassembleUtil.cpp:130)
            int64_t layer = (t_real < 5) ? t_real : 5;
            if (t_real >= tl - 5) layer = 6 + (t_real - (tl - 5));
            const int64_t slot = (goff + qst + p) * 44 + base * 11 + layer;
#pragma omp atomic
            counts[slot]++;
            if (rev) {
#pragma omp atomic
                rev_counts[slot]++;
            }
        }
    }
}

// writeKmerMatcherResult scan (kmermatcher.cpp:841-929): over entries
// sorted by (centre, member, diagonal), emit one hit per (centre, member)
// with the longest-run diagonal (ties -> later run) and the shared-k-mer
// count as score (negative = reverse strand).  Faithful to the reference
// quirk that the per-member look-ahead does NOT stop at the centre-group
// boundary.  Rows for each written centre start with a self-hit.
// Returns the number of rows; groups_* receive per-written-centre info.
int64_t build_pref_scan(
    const int64_t *c, const uint8_t *f, const int64_t *m, const int32_t *d,
    int64_t n, const uint32_t *keys,
    uint32_t *qkey_o, uint32_t *tkey_o, int32_t *score_o, int32_t *diag_o,
    int64_t *group_row_start, int64_t *group_centre, int64_t *n_groups_o)
{
    int64_t n_rows = 0, n_groups = 0;
    int64_t rep = -1;
    int64_t block_start = 0;   // row index of the pending centre's self-hit
    int64_t wrote = 0;
    int64_t last_target = -1;
    bool have_last = false;

    auto flush = [&]() {
        if (rep >= 0 && wrote > 0) {
            group_row_start[n_groups] = block_start;
            group_centre[n_groups] = rep;
            n_groups++;
        } else if (rep >= 0) {
            n_rows = block_start;   // drop the unused self-hit row
        }
    };

    for (int64_t i = 0; i < n; i++) {
        const int64_t centre = c[i];
        const bool rever_mask = !f[i];
        if (rep < 0 || centre != rep) {
            flush();
            rep = centre;
            block_start = n_rows;
            qkey_o[n_rows] = keys[centre];
            tkey_o[n_rows] = keys[centre];
            score_o[n_rows] = 0;
            diag_o[n_rows] = 0;
            n_rows++;
            wrote = 0;
            have_last = false;
            last_target = -1;
        }
        const int64_t target = m[i];
        int32_t diagonal = d[i];
        bool best_rev = rever_mask;
        int32_t prev_diag = diagonal;
        int64_t max_diag = 0, diag_cnt = 0, top = 0;
        if (!(have_last && last_target == target)) {
            for (int64_t j = i; j < n && m[j] == target; j++) {
                diag_cnt = (prev_diag == d[j]) ? diag_cnt + 1 : 1;
                if (diag_cnt >= max_diag) {
                    diagonal = d[j];
                    max_diag = diag_cnt;
                    best_rev = !f[j];
                }
                prev_diag = d[j];
                top++;
            }
        }
        if (target == rep || (have_last && last_target == target)) {
            last_target = target;
            have_last = true;
            continue;
        }
        qkey_o[n_rows] = keys[rep];
        tkey_o[n_rows] = keys[target];
        score_o[n_rows] = (int32_t)(best_rev ? -top : top);
        diag_o[n_rows] = (int32_t)(int16_t)diagonal;   // short truncation
        n_rows++;
        wrote++;
        last_target = target;
        have_last = true;
    }
    flush();
    *n_groups_o = n_groups;
    return n_rows;
}

// Circular-contig detection (src/assembler/cyclecheck.cpp:77-254): split
// each contig into thirds, count shared k-mers between thirds per diagonal
// (diag >= L/3), and report the first diagonal whose ±1% band hit-rate
// exceeds 0.24.  Output per sequence: the split diagonal (0 = not
// circular), matching the Python oracle in stages/cyclecheck.py.
void cyclecheck_batch(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    int64_t n_seqs, int64_t k, int64_t max_seq_len,
    int32_t *split_o)
{
#pragma omp parallel
    {
        std::vector<std::pair<uint64_t, int64_t>> front, middle, back;
        std::vector<int64_t> diag_hits;
#pragma omp for schedule(dynamic, 16)
        for (int64_t s = 0; s < n_seqs; s++) {
            split_o[s] = 0;
            const int64_t L = lengths[s];
            if (L >= max_seq_len || L < k) continue;
            const uint8_t *sq = data + offsets[s];
            const int64_t n = L - k + 1;
            const int64_t third = L / 3;

            // k-mer index per window: base-4 positional arithmetic over
            // codes 0..4 — X=4 aliases into the next digit exactly like
            // Indexer::int2index (cyclecheck.cpp:83,118).  The alias makes
            // the value depend on carries, so no rolling update: recompute
            // each window (k multiplies).
            front.clear(); middle.clear(); back.clear();
            for (int64_t p = 0; p + k <= L; p++) {
                uint64_t v = 0;
                for (int64_t j = 0; j < k; j++) v = v * 4 + T.code[sq[p + j]];
                if (p < third + 1) front.emplace_back(v, p);
                else if (p < 2 * third + 1) middle.emplace_back(v, p);
                else back.emplace_back(v, p);
            }
            std::sort(front.begin(), front.end());
            std::sort(middle.begin(), middle.end());
            std::sort(back.begin(), back.end());

            diag_hits.assign(2 * third + 1, 0);
            int64_t kmermatches = 0;
            auto join = [&](const std::vector<std::pair<uint64_t, int64_t>> &src,
                            bool src_unique,
                            const std::vector<std::pair<uint64_t, int64_t>> &dst) {
                size_t i = 0, j = 0;
                while (i < src.size() && j < dst.size()) {
                    if (src_unique && i > 0 && src[i].first == src[i - 1].first) {
                        i++;   // only the lowest-position entry per kmer
                        continue;
                    }
                    if (src[i].first < dst[j].first) { i++; continue; }
                    if (dst[j].first < src[i].first) { j++; continue; }
                    // walk all dst entries with this kmer
                    for (size_t jj = j; jj < dst.size() &&
                                        dst[jj].first == src[i].first; jj++) {
                        const int64_t diag = dst[jj].second - src[i].second;
                        if (diag >= third) {
                            diag_hits[diag - third]++;
                            kmermatches++;
                        }
                    }
                    i++;   // j stays: next unique src kmer may differ
                }
            };
            join(front, true, back);
            join(front, true, middle);
            join(middle, true, back);

            if (kmermatches == 0) continue;
            for (int64_t d = 0; d < 2 * third; d++) {
                if (diag_hits[d] == 0) continue;
                const int64_t diag = d + third;
                const int64_t diaglen = L - diag;
                const int64_t gap = (int64_t)(diaglen * 0.01);
                const int64_t lower = d - gap > 0 ? d - gap : 0;
                const int64_t upper = d + gap < 2 * third ? d + gap : 2 * third;
                int64_t band_hits = 0;
                for (int64_t b = lower; b <= upper; b++)
                    if (diag_hits[b] <= diag_hits[d]) band_hits += diag_hits[b];
                // NumPy-oracle semantics: f32 division, f32 compare
                const float rate = (float)band_hits / (float)(diaglen - k + 1);
                if (rate > 0.24f) {
                    split_o[s] = (int32_t)diag;
                    break;
                }
            }
        }
    }
}

}  // extern "C"
