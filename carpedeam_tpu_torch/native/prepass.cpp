// Native host runtime: batched per-record pre-pass scoring for the two
// greedy extension stages, whole-stage Bayesian correction, and k-mer
// extraction/selection for the overlap prefilter.
//
// These kernels replace the NumPy dense-window formulations of
// ops/extension_batch.py and stages/correction.py on the host path: the
// NumPy versions materialise (records x Lmax) index/byte matrices per
// pass (fine as oracles, memory-bound at production scale); here every
// record/query is a cache-resident scalar loop, OpenMP-parallel like the
// reference's `#pragma omp parallel for schedule(dynamic)` per-sequence
// loops (src/assembler/ancientContigsResults.cpp:166-227,
// ancientReadsResults.cpp:179-366, correction.cpp:200-463,
// lib/mmseqs/src/linclust/kmermatcher.cpp:78-386).
//
// Float semantics replicate the validated NumPy batch implementations
// exactly (np.float32 step-by-step arithmetic where the reference uses
// float, IEEE f64 for likelihood sums); byte-identical end-to-end output
// is enforced by tests/test_contig_phase.py::test_golden_full_nuclassemble.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Tables {
    uint8_t code[256];        // 5-letter fold A0 C1 T2 G3 X4
    uint8_t revcomp_n[256];   // char -> complement char via "ACTGN" decode
    uint8_t ry[256];          // purine/pyrimidine ('C'/'T' -> 1)
    uint8_t acgt[256];        // nucleotideMap (A0 C1 G2 T3, else 0)
    Tables() {
        memset(code, 4, sizeof(code));
        const char *a = "Aa", *c = "CcMmYyHh", *t = "TtUuWw",
                   *g = "GgKkBbDdVvRrSs";
        for (const char *p = a; *p; p++) code[(uint8_t)*p] = 0;
        for (const char *p = c; *p; p++) code[(uint8_t)*p] = 1;
        for (const char *p = t; *p; p++) code[(uint8_t)*p] = 2;
        for (const char *p = g; *p; p++) code[(uint8_t)*p] = 3;
        const char dec_n[6] = "ACTGN";
        static const uint8_t comp[5] = {2, 3, 0, 1, 4};
        for (int i = 0; i < 256; i++)
            revcomp_n[i] = (uint8_t)dec_n[comp[code[i]]];
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

inline int64_t clamp_idx(int64_t i, int64_t n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// deamMatches posterior for one column, bit-exact to the reference
// (nuclassembleUtil.cpp:1011-1047): DOUBLE arithmetic throughout, with
// the reference's f32 sub-expressions (3.0f*alnLength is a float
// product; 0.9f widens to double(0.9f)); scoreAln is unsigned int.
inline double deam_matches_ref(int64_t aln_len, int64_t score_aln,
                               double match_lik) {
    const double log_adj = std::log(1.4e-9);
    const double log_min = log_adj - 3.0 * std::log(10.0);
    const double log_max = log_adj - 3.0 * std::log(100000.0);
    const int64_t len_c = aln_len < 100000 ? aln_len : 100000;
    const double log_len = log_adj - 3.0 * std::log((double)len_c);
    const double frac = (std::fabs(log_len) - std::fabs(log_max)) /
                        (std::fabs(log_min) - std::fabs(log_max));
    const double prior_aln = 1.0 - frac;
    const double a = (double)(uint32_t)score_aln +
                     (double)(3.0f * (float)aln_len);
    const double p_match =
        0.5 * ((a / 5.0 + (double)0.9f) / (double)(aln_len + 1)) +
        0.5 * prior_aln;
    const double lik_no = 1.0 - p_match;
    const double odds_ratio = lik_no / match_lik;
    const double odds = (1.0 - p_match) / p_match;
    return 1.0 / (1.0 + odds_ratio * odds);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Contig-merge pre-pass (batch_contig_scoring minus the cheap vector ops):
// per alignment record with CANONICAL coords, computes
//   pass-B plain/RY identity counts over the [qs, qe] query window,
//   the candidate gate (f32 identity thresholds + not-identity),
//   the safe-mode consensus update counts (consensus == query),
//   and ancientMatchCount (damage-discounted match count).
// Index/boundary semantics mirror the NumPy oracle: global data indices
// clamp into [0, total_len).
// ---------------------------------------------------------------------------
void contig_prepass(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    int64_t total_len,
    const int32_t *qid, const int32_t *tid, const uint8_t *is_rev,
    const int32_t *qs_a, const int32_t *qe_a, const int32_t *ts_a,
    const int32_t *te_a, const int32_t *alen_a,
    const uint8_t *not_identity, int64_t n_rec,
    float merge_thr, float ry_thr,
    const double *lik5_f, const double *lik5_r,   // (4,4) interior layers
    int64_t *idc_o, int64_t *ryc_o, uint8_t *cand_o,
    double *seq_id_o, double *ry_seq_id_o,
    int64_t *aln_len_cons_o, double *deam_match_o)
{
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n_rec; r++) {
        const int64_t q = qid[r], t = tid[r];
        const int64_t ql = lengths[q], tl = lengths[t];
        const int64_t qoff = offsets[q], toff = offsets[t];
        const bool rev = is_rev[r] != 0;
        const int64_t qs = qs_a[r], qe = qe_a[r];
        const int64_t ts = ts_a[r], te = te_a[r];
        const int64_t alen = alen_a[r];

        auto tbyte = [&](int64_t p) -> uint8_t {
            // target char at canonical position p with clamped-global-index
            // NumPy semantics (extension_batch.py::t_gather)
            if (rev)
                return T.revcomp_n[data[clamp_idx(toff + tl - 1 - p,
                                                  total_len)]];
            return data[clamp_idx(toff + p, total_len)];
        };
        auto qbyte = [&](int64_t p) -> uint8_t {
            return data[clamp_idx(qoff + p, total_len)];
        };

        // ---- pass B over the query window ------------------------------
        const int64_t win = qe - qs + 1;
        int64_t idc = 0, ryc = 0;
        for (int64_t i = 0; i < win; i++) {
            const uint8_t qb = qbyte(qs + i), tb = tbyte(ts + i);
            idc += (qb == tb);
            ryc += (T.ry[qb] == T.ry[tb]);
        }
        idc_o[r] = idc;
        ryc_o[r] = ryc;
        double seq_id = (double)((float)idc / (float)alen);
        double ry_seq_id = (double)((float)ryc / (float)alen);
        const bool cand = not_identity[r] &&
                          (float)seq_id >= merge_thr &&
                          (float)ry_seq_id >= ry_thr;
        cand_o[r] = cand;
        aln_len_cons_o[r] = 0;
        deam_match_o[r] = 0.0;
        if (!cand) {
            seq_id_o[r] = seq_id;
            ry_seq_id_o[r] = ry_seq_id;
            continue;
        }

        // ---- consensus update (safe mode: consensus == query) ----------
        const bool right_c = (ts == 0) && (qe == ql - 1);
        const bool left_c = (qs == 0) && (te == tl - 1);
        const int64_t offs = tl - alen;
        const bool valid = (right_c || left_c) && (ql - offs) >= 0;
        const int64_t qpos0 = left_c ? -offs : ql - alen;
        const int64_t cons0 = left_c ? ql - offs : 2 * ql - alen;
        int64_t total = 0, idc2 = 0, ryc2 = 0;
        const int64_t mm_base = left_c ? 0 : 0;  // (suppress unused warn)
        (void)mm_base;
        const double *lik5 = rev ? lik5_r : lik5_f;
        // first sweep: counts for the updated identities
        for (int64_t i = 0; i < tl; i++) {
            const int64_t qp = qpos0 + i;
            const bool q_in = qp >= 0 && qp < ql;
            const int64_t cons_pos = cons0 + i;
            const bool in_rng = cons_pos >= 0 && cons_pos < 3 * ql;
            const uint8_t tb = tbyte(i);
            const uint8_t qb = qbyte(qp);
            const bool use = (tb != 'N') && q_in && in_rng && (qb != 'N');
            if (!use) continue;
            total++;
            idc2 += (qb == tb);
            ryc2 += (T.ry[qb] == T.ry[tb]);
        }
        if (valid && total > 0) {
            seq_id = (double)((float)idc2 / (float)total);
            ry_seq_id = (double)((float)ryc2 / (float)total);
        }
        const int64_t aln_len_cons = valid ? total : 0;
        aln_len_cons_o[r] = aln_len_cons;
        seq_id_o[r] = seq_id;
        ry_seq_id_o[r] = ry_seq_id;

        // ---- ancientMatchCount (nuclassembleUtil.cpp:1050-1182) ---------
        const int64_t mm_cons =
            (int64_t)((1.0f - (float)seq_id) * (float)aln_len_cons + 0.5f);
        const int64_t m_cons = aln_len_cons - mm_cons;
        int64_t score_aln = m_cons * 2 - mm_cons * 3;
        if (score_aln < 0) score_aln += ((int64_t)1) << 32;  // uint wrap
        float m_ct = 0.0f, m_ga = 0.0f;
        if (valid) {
            for (int64_t i = 0; i < tl; i++) {
                const int64_t qp = qpos0 + i;
                const bool q_in = qp >= 0 && qp < ql;
                const int64_t cons_pos = cons0 + i;
                const bool in_rng = cons_pos >= 0 && cons_pos < 3 * ql;
                const uint8_t tb = tbyte(i);
                const uint8_t qb = qbyte(qp);
                const bool use = (tb != 'N') && q_in && in_rng && (qb != 'N');
                if (!use) continue;
                const int64_t qb4 = T.acgt[qb], tb4 = T.acgt[tb];
                const double lik = lik5[qb4 * 4 + tb4];
                if (lik <= 0) continue;
                // float += double: computed in double, rounded to f32
                // per step (the reference's `float mCT += posterior`)
                if (qb4 == 1 && tb4 == 3)
                    m_ct += deam_matches_ref(alen, score_aln, lik);
                else if (qb4 == 2 && tb4 == 0)
                    m_ga += deam_matches_ref(alen, score_aln, lik);
            }
        }
        const float base =
            ((float)score_aln + 3.0f * (float)aln_len_cons) / 5.0f;
        deam_match_o[r] = (double)(base + m_ct + m_ga);
    }
}

// ---------------------------------------------------------------------------
// Read-phase pre-pass (batch_initial_scoring minus the cheap vector ops):
// per TERMINAL alignment record (raw-coordinate test already applied by
// the caller; read phase is forward-strand by construction), computes
//   pass-B identities over the [qs, qe] query window,
//   the pass-C candidate gate,
//   the safe-mode consensus update counts and side totals,
//   and the damage log-likelihood column sum (f64).
// ---------------------------------------------------------------------------
void read_prepass(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    int64_t total_len,
    const int32_t *qid, const int32_t *tid,
    const int32_t *qs_a, const int32_t *qe_a, const int32_t *ts_a,
    const int32_t *te_a, const int32_t *alen_a,
    const uint8_t *terminal, const uint8_t *ext_t, int64_t n_rec,
    float seq_id_thr,
    const double *logm,     // (11,4,4) log-likelihood table
    int64_t *idc_o, int64_t *ryc_o, uint8_t *cand_o,
    double *seq_id_o, double *ry_seq_id_o,
    int64_t *cons_total_o, uint8_t *cons_valid_o, uint8_t *cons_left_o,
    long double *lik_mod_o, int64_t *aln_count_o)
{
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < n_rec; r++) {
        idc_o[r] = 0; ryc_o[r] = 0; cand_o[r] = 0;
        seq_id_o[r] = 0.0; ry_seq_id_o[r] = 0.0;
        cons_total_o[r] = 0; cons_valid_o[r] = 0; cons_left_o[r] = 0;
        lik_mod_o[r] = 0.0; aln_count_o[r] = 0;
        if (!terminal[r]) continue;
        const int64_t q = qid[r], t = tid[r];
        const int64_t ql = lengths[q], tl = lengths[t];
        const int64_t qoff = offsets[q], toff = offsets[t];
        const int64_t qs = qs_a[r], qe = qe_a[r];
        const int64_t ts = ts_a[r], te = te_a[r];
        const int64_t alen = alen_a[r];

        auto dbyte = [&](int64_t gi) -> uint8_t {
            return data[clamp_idx(gi, total_len)];
        };

        // ---- pass B ------------------------------------------------------
        const int64_t win = qe - qs + 1;
        int64_t idc = 0, ryc = 0;
        for (int64_t i = 0; i < win; i++) {
            const uint8_t qb = dbyte(qoff + qs + i);
            const uint8_t tb = dbyte(toff + ts + i);
            idc += (qb == tb);
            ryc += (T.ry[qb] == T.ry[tb]);
        }
        idc_o[r] = idc;
        ryc_o[r] = ryc;
        double seq_id = (double)((float)idc / (float)alen);
        double ry_seq_id = (double)((float)ryc / (float)alen);
        seq_id_o[r] = seq_id;
        ry_seq_id_o[r] = ry_seq_id;

        // ---- pass C ------------------------------------------------------
        const bool no_offset = (tl - alen) == 0;
        const bool cand = !ext_t[r] && alen >= 30 &&
                          (float)seq_id >= seq_id_thr && !no_offset;
        cand_o[r] = cand;
        if (!cand) continue;

        // ---- consensus update + likelihood columns ----------------------
        const bool right_c = (ts == 0) && (qe == ql - 1);
        const bool left_c = (qs == 0) && (te == tl - 1);
        const int64_t offs = tl - alen;
        const bool valid = (right_c || left_c) && (ql - offs) >= 0;
        const int64_t qpos0 = left_c ? -offs : ql - alen;
        const int64_t cons0 = left_c ? ql - offs : 2 * ql - alen;
        int64_t total = 0, idc2 = 0, ryc2 = 0;
        // 80-bit sequential accumulation: the reference's `long double
        // likMod += log(lik)` (nuclassembleUtil.cpp:212,279) — last-ulp
        // distinctions decide priority-queue ties at scale
        long double lm = 0.0L;
        int64_t ac = 0;
        int64_t t_rank = -1;
        for (int64_t i = 0; i < tl; i++) {
            const uint8_t tb = dbyte(toff + i);
            const bool t_nn = tb != 'N';
            if (t_nn) t_rank++;
            const int64_t qp = qpos0 + i;
            const bool q_in = qp >= 0 && qp < ql;
            const int64_t cons_pos = cons0 + i;
            const bool in_rng = cons_pos >= 0 && cons_pos < 3 * ql;
            const uint8_t qb = dbyte(qoff + qp);
            const bool use = t_nn && q_in && in_rng && (qb != 'N');
            if (!use) continue;
            total++;
            idc2 += (qb == tb);
            ryc2 += (T.ry[qb] == T.ry[tb]);
            // damage layer of the target column (extension_batch.py:163-167)
            int64_t lay = t_rank < 5 ? (t_rank > 0 ? t_rank : 0) : 5;
            const int64_t from_end = t_rank - (tl - 5);
            if (from_end >= 0) lay = 6 + from_end;
            if (lay > 10) lay = 10;
            const int64_t qb4 = T.acgt[qb], tb4 = T.acgt[tb];
            lm += logm[(lay * 4 + qb4) * 4 + tb4];
            ac++;
        }
        if (valid && total > 0) {
            seq_id_o[r] = (double)((float)idc2 / (float)total);
            ry_seq_id_o[r] = (double)((float)ryc2 / (float)total);
        }
        cons_total_o[r] = valid ? total : 0;
        cons_valid_o[r] = valid;
        cons_left_o[r] = left_c;
        lik_mod_o[r] = valid ? lm : 0.0L;
        aln_count_o[r] = valid ? ac : 0;
    }
}

// ---------------------------------------------------------------------------
// Whole-stage Bayesian correction (stages/correction.py device-free path):
// per query GROUP of alignment records, accumulate the (L,4,11) coverage
// stack in a thread-local buffer and emit the corrected bytes directly —
// no (total_len,4,11) global tensor, no atomics.  Group g covers records
// [rec_starts[g], rec_starts[g+1]) of the flat record arrays; group_q[g]
// is the query's row.  out must be pre-filled with the original data.
// ---------------------------------------------------------------------------
void correction_groups(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const uint8_t *ext, int64_t n_groups,
    const int64_t *rec_starts, const int32_t *group_q,
    const int32_t *rec_t, const uint8_t *rec_is_rev,
    const int32_t *rec_qstart, const int32_t *rec_tstart,
    const int32_t *rec_alen, const uint8_t *rec_keep_pre,
    const int32_t *rec_ry_smin,
    const double *log_err,      // (4,4)  [q][obs]
    const double *log_deam_f,   // (11,4,4) [l][q][t]
    const double *log_deam_r,
    uint8_t *out)
{
#pragma omp parallel
    {
        std::vector<int32_t> cnt, rcnt;
#pragma omp for schedule(dynamic, 16)
        for (int64_t g = 0; g < n_groups; g++) {
            const int64_t q = group_q[g];
            const int64_t L = lengths[q];
            const int64_t goff = offsets[q];
            const uint8_t *qb = data + goff;
            const bool q_ext = ext[q] != 0;
            if ((int64_t)cnt.size() < L * 44) {
                cnt.resize(L * 44);
                rcnt.resize(L * 44);
            }
            memset(cnt.data(), 0, L * 44 * sizeof(int32_t));
            memset(rcnt.data(), 0, L * 44 * sizeof(int32_t));

            bool any = false;
            for (int64_t r = rec_starts[g]; r < rec_starts[g + 1]; r++) {
                if (!rec_keep_pre[r]) continue;
                const int64_t t = rec_t[r];
                const int64_t tl = lengths[t];
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
                any = true;
                for (int64_t p = 0; p < alen; p++) {
                    const int64_t t_real = tst + p;
                    const uint8_t tch = tbyte(t_real);
                    const int64_t base = T.acgt[tch];
                    int64_t layer = (t_real < 5) ? t_real : 5;
                    if (t_real >= tl - 5) layer = 6 + (t_real - (tl - 5));
                    const int64_t slot = (qst + p) * 44 + base * 11 + layer;
                    cnt[slot]++;
                    if (rev) rcnt[slot]++;
                }
            }
            if (!any) continue;

            for (int64_t p = 0; p < L; p++) {
                const int32_t *c = cnt.data() + p * 44;
                const int32_t *rc = rcnt.data() + p * 44;
                int64_t tot = 0;
                int64_t base_cov[4] = {0, 0, 0, 0};
                for (int64_t tb4 = 0; tb4 < 4; tb4++) {
                    int64_t s = 0;
                    for (int64_t l = 0; l < 11; l++) s += c[tb4 * 11 + l];
                    base_cov[tb4] = s;
                    tot += s;
                }
                if (tot <= 1) continue;   // passthrough (correction.cpp:418)
                const int64_t obs = T.acgt[qb[p]];
                int64_t own_layer = p < 5 ? p : 5;
                if (p >= L - 5) own_layer = 6 + (p - (L - 5));
                double best = 0.0;
                int64_t best_q = 0;
                for (int64_t qb4 = 0; qb4 < 4; qb4++) {
                    const double logq =
                        q_ext ? log_err[qb4 * 4 + obs]
                              : log_deam_f[(own_layer * 4 + qb4) * 4 + obs];
                    double lik = (double)tot * logq;
                    // contraction over (t, l) in the (t*11+l) flat order of
                    // the NumPy matmul path (correction.py:113-120)
                    for (int64_t j = 0; j < 44; j++) {
                        const int64_t tb4 = j / 11, l = j % 11;
                        const double wf = log_deam_f[(l * 4 + qb4) * 4 + tb4];
                        const double wr = log_deam_r[(l * 4 + qb4) * 4 + tb4];
                        lik += (double)(c[j] - rc[j]) * wf + (double)rc[j] * wr;
                    }
                    if (qb4 == 0 || lik > best) {
                        best = lik;
                        best_q = qb4;
                    }
                }
                // ratio early-exits (exact-rational form of f64 >= 0.4)
                int64_t pick = best_q;
                if (!q_ext && (5 * base_cov[3] >= 2 * tot ||
                               5 * base_cov[0] >= 2 * tot))
                    pick = obs;
                out[goff + p] = (uint8_t)"ACGT"[pick];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// k-mer extraction + canonicalisation + xxh64 subsampling hash +
// per-sequence (hash, kmer|b63, pos) sort + selection walk, one pass per
// sequence (kmermatcher.cpp:78-386).  Entry 0 of every sequence's output
// region is the whole-sequence identity entry (Util::hash polynomial);
// the remaining count[s]-1 entries are the selected k-mers.  out regions
// start at out_offsets[s] (capacity 1 + L - k + 1 per sequence).
// ---------------------------------------------------------------------------
void kmer_extract(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    int64_t n_seqs, int64_t k, uint64_t seed,
    int64_t kmers_per_sequence, float kmers_per_sequence_scale,
    const int64_t *out_offsets,
    uint64_t *kmer_o, int32_t *pos_o, uint16_t *h16_o, int64_t *count_o)
{
    const uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
    auto xxh64_u64 = [&](uint64_t v) -> uint64_t {
        uint64_t k1 = v * P2;
        k1 = (k1 << 31) | (k1 >> 33);
        k1 *= P1;
        uint64_t acc = seed + P5 + 8;
        acc ^= k1;
        acc = ((acc << 27) | (acc >> 37)) * P1 + P4;
        acc ^= acc >> 33;
        acc *= P2;
        acc ^= acc >> 29;
        acc *= P3;
        acc ^= acc >> 32;
        return acc;
    };
    const uint64_t M2 = 0x3333333333333333ull, M4 = 0x0F0F0F0F0F0F0F0Full;
    const uint64_t COMP = 0xAAAAAAAAAAAAAAAAull;
    const uint64_t BIT63 = 1ull << 63;
    auto revcomp = [&](uint64_t x) -> uint64_t {
        x ^= COMP;
        x = ((x >> 2) & M2) | ((x & M2) << 2);
        x = ((x >> 4) & M4) | ((x & M4) << 4);
        x = __builtin_bswap64(x);
        return x >> (64 - 2 * k);
    };
    const uint64_t kmask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);

    struct Entry {
        uint16_t h16;
        uint64_t masked;   // kmer | BIT63 (dup detection ignores strand)
        uint64_t field;    // kmer with the real strand bit
        int32_t pos;
        bool operator<(const Entry &o) const {
            if (h16 != o.h16) return h16 < o.h16;
            if (masked != o.masked) return masked < o.masked;
            return pos < o.pos;
        }
    };

#pragma omp parallel
    {
        std::vector<Entry> ent;
        std::vector<int32_t> score_dist(65536), hier(128);
#pragma omp for schedule(dynamic, 16)
        for (int64_t s = 0; s < n_seqs; s++) {
            const int64_t L = lengths[s];
            const uint8_t *sq = data + offsets[s];
            uint64_t *ko = kmer_o + out_offsets[s];
            int32_t *po = pos_o + out_offsets[s];
            uint16_t *ho = h16_o + out_offsets[s];

            // identity entry (Util::hash base-31 polynomial over codes)
            uint64_t h = 0;
            for (int64_t p = 0; p < L; p++) h = h * 31 + T.code[sq[p]];
            const uint64_t ih = xxh64_u64(h);
            ko[0] = ih;
            po[0] = 0;
            ho[0] = (uint16_t)(ih & 0xFFFF);
            int64_t n_out = 1;

            // window walk: rolling 2-bit pack with X invalidation
            ent.clear();
            uint64_t kmer = 0;
            int64_t since_x = 0;   // consecutive non-X codes ending here
            for (int64_t p = 0; p < L; p++) {
                const uint8_t cd = T.code[sq[p]];
                if (cd > 3) {
                    since_x = 0;
                    kmer = 0;
                    continue;
                }
                kmer = ((kmer << 2) | cd) & kmask;
                since_x++;
                if (since_x < k) continue;
                const int64_t start = p - k + 1;
                const uint64_t rc = revcomp(kmer);
                if (rc == kmer) continue;            // palindrome skip
                const bool pick_rev = rc < kmer;
                const uint64_t canon = pick_rev ? rc : kmer;
                Entry e;
                e.h16 = (uint16_t)(xxh64_u64(canon) & 0xFFFF);
                e.field = pick_rev ? canon : (canon | BIT63);
                e.masked = e.field | BIT63;
                e.pos = (int32_t)(pick_rev ? L - start - k : start);
                ent.push_back(e);
            }
            const int64_t n = (int64_t)ent.size();
            if (n == 0) {
                count_o[s] = n_out;
                continue;
            }
            std::sort(ent.begin(), ent.end());

            int64_t considered =
                (int64_t)((float)(kmers_per_sequence - 1) +
                          kmers_per_sequence_scale * (float)L);
            if (considered > n) considered = n;

            // histogram threshold (65536 bins via the 128-bin hierarchy).
            // score_dist is NOT memset here: 256KB per sequence would cost
            // more than the rest of the stage; instead the touched bins
            // (one per entry) are re-zeroed after the walk below.
            memset(hier.data(), 0, 128 * sizeof(int32_t));
            for (int64_t i = 0; i < n; i++) {
                score_dist[ent[i].h16]++;
                hier[ent[i].h16 >> 9]++;
            }
            int64_t kmer_in_bins = 0;
            int hier_thr = 0;
            while (hier_thr < 128 && kmer_in_bins < considered) {
                kmer_in_bins += hier[hier_thr];
                hier_thr++;
            }
            hier_thr -= (hier_thr > 0) ? 1 : 0;
            kmer_in_bins -= hier[hier_thr];
            int64_t threshold = (int64_t)hier_thr * 512;
            while (threshold <= 0xFFFF && kmer_in_bins < considered) {
                kmer_in_bins += score_dist[threshold];
                threshold++;
            }
            int64_t too_much = kmer_in_bins - considered;

            // selection walk with duplicate-run skipping
            int64_t sel_count = 0;
            for (int64_t i = 0; i < n && sel_count < considered; i++) {
                if (i + 1 < n && ent[i].masked == ent[i + 1].masked) {
                    const uint64_t cur = ent[i].masked;
                    while (i < n && ent[i].masked == cur) i++;
                    if (i >= n) break;
                }
                if ((int64_t)ent[i].h16 < threshold) {
                    if ((int64_t)ent[i].h16 == threshold - 1 && too_much) {
                        too_much--;
                        if (too_much == 0) threshold--;
                    }
                    sel_count++;
                    ko[n_out] = ent[i].field;
                    po[n_out] = ent[i].pos;
                    ho[n_out] = ent[i].h16;
                    n_out++;
                }
            }
            for (int64_t i = 0; i < n; i++) score_dist[ent[i].h16] = 0;
            count_o[s] = n_out;
        }
    }
}

// ---------------------------------------------------------------------------
// Global k-mer table sort (the ips4o SORT_PARALLEL analogue,
// kmermatcher.cpp:409-415): permutation index ordered by
// (kmer|bit63 asc, seq_len desc, id asc, pos asc).
// ---------------------------------------------------------------------------
void sort_kmer_entries(
    const uint64_t *kmer, const int64_t *id, const int32_t *pos,
    const int32_t *seq_len, int64_t n, int64_t *order_o)
{
    struct Row {
        uint64_t key;
        uint64_t tie;    // (~len)<<40 | id  (id < 2^40, len < 2^24)
        int32_t pos;
        int64_t idx;
        bool operator<(const Row &o) const {
            if (key != o.key) return key < o.key;
            if (tie != o.tie) return tie < o.tie;
            return pos < o.pos;
        }
    };
    std::vector<Row> rows(n);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        rows[i].key = kmer[i] | (1ull << 63);
        rows[i].tie = ((uint64_t)(0xFFFFFF - (uint32_t)seq_len[i]) << 40) |
                      (uint64_t)id[i];
        rows[i].pos = pos[i];
        rows[i].idx = i;
    }
#ifdef _OPENMP
    // two-way parallel merge sort (the host has few cores; deeper
    // parallelism would not pay for the merge passes)
    const int64_t half = n / 2;
    if (n > (1 << 16)) {
#pragma omp parallel sections
        {
#pragma omp section
            std::sort(rows.begin(), rows.begin() + half);
#pragma omp section
            std::sort(rows.begin() + half, rows.end());
        }
        std::inplace_merge(rows.begin(), rows.begin() + half, rows.end());
    } else {
        std::sort(rows.begin(), rows.end());
    }
#else
    std::sort(rows.begin(), rows.end());
#endif
    for (int64_t i = 0; i < n; i++) order_o[i] = rows[i].idx;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Compact the per-sequence capacity regions kmer_extract wrote into exact
// entry arrays (+ id / seq_len columns) — parallel per-sequence memcpy,
// replacing an np.repeat/boolean-mask pass that allocated several
// windows-sized temporaries per call.
// ---------------------------------------------------------------------------
extern "C" void kmer_compact(
    const uint64_t *kmer_o, const int32_t *pos_o, const uint16_t *h16_o,
    const int64_t *out_offsets, const int64_t *count_o,
    const int64_t *lengths, int64_t n_seqs, const int64_t *dst_offsets,
    uint64_t *kmer_c, int64_t *id_c, int32_t *pos_c, int32_t *len_c,
    uint16_t *h16_c)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t s = 0; s < n_seqs; s++) {
        const int64_t cnt = count_o[s];
        const int64_t src = out_offsets[s], dst = dst_offsets[s];
        memcpy(kmer_c + dst, kmer_o + src, (size_t)cnt * sizeof(uint64_t));
        memcpy(pos_c + dst, pos_o + src, (size_t)cnt * sizeof(int32_t));
        memcpy(h16_c + dst, h16_o + src, (size_t)cnt * sizeof(uint16_t));
        const int32_t L = (int32_t)lengths[s];
        for (int64_t i = 0; i < cnt; i++) {
            id_c[dst + i] = s;
            len_c[dst + i] = L;
        }
    }
}

// ---------------------------------------------------------------------------
// Correction output scatter: un-nibble the Pallas kernel's packed plane
// (block row b*G/2+g holds slots g in the low and g+G/2 in the high
// nibble) and write corrected bases (nibble >= 4 marks a written
// position) into the flat sequence store.  Each valid slot owns a unique
// query (correction_pallas block builder), so rows are race-free.
// ---------------------------------------------------------------------------
// Per-sequence non-ACGT flag: 1 if any byte outside uppercase "ACGT"
// (ops/window_pallas.has_non_acgt_flags oracle; early-exit per row).
extern "C" void seq_non_acgt_flags(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    int64_t n_seq, uint8_t *flags)
{
    uint8_t pure[256];
    memset(pure, 1, sizeof(pure));
    pure[(uint8_t)'A'] = pure[(uint8_t)'C'] = pure[(uint8_t)'G'] =
        pure[(uint8_t)'T'] = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n_seq; i++) {
        const uint8_t *p = data + offsets[i];
        const int64_t L = lengths[i];
        uint8_t f = 0;
        for (int64_t j = 0; j < L; j++)
            if (pure[p[j]]) { f = 1; break; }
        flags[i] = f;
    }
}

// Un-2-bit the correction kernel's packed output (four query slots per
// byte: slot g in bit pair g/(G/4)) and write EVERY position < qlen
// (the coverage gate is folded on device; non-ACGT queries never reach
// this path, so ACGT[code] reproduces unchanged bytes exactly).
extern "C" void corr_unpack2_scatter(
    const uint8_t *packed, int64_t nb, int64_t G, int64_t max_len,
    const uint8_t *slot_valid, const int32_t *slot_qid,
    const int64_t *qid_of, const int64_t *lens_global,
    const int64_t *offsets, uint8_t *out_flat)
{
    static const char acgt[5] = "ACGT";
    const int64_t quarter = G / 4;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t s = 0; s < nb * G; s++) {
        if (!slot_valid[s]) continue;
        const int64_t b = s / G, g = s % G;
        const uint8_t *row = packed + (b * quarter + (g % quarter)) * max_len;
        const int shift = 2 * (int)(g / quarter);
        const int64_t qg = qid_of[slot_qid[s]];
        int64_t L = lens_global[qg];
        if (L > max_len) L = max_len;
        uint8_t *dst = out_flat + offsets[qg];
        for (int64_t p = 0; p < L; p++)
            dst[p] = (uint8_t)acgt[(row[p] >> shift) & 3];
    }
}

// ---------------------------------------------------------------------------
// Exact sRatio from the 80-bit likelihood: the reference computes
// `double ratioLog = 1.0/(1.0+exp(randAln-likMod))` with likMod still in
// long double (nuclassembleUtil.cpp:340), so the exp resolves to expl.
// lik_ld must already include the excess-penalty term.
// ---------------------------------------------------------------------------
extern "C" void lik_ratio_ld(const double *rand_aln, const long double *lik_ld,
                             int64_t n, double *ratio_o)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; i++) {
        ratio_o[i] = (double)(1.0L /
                              (1.0L + expl((long double)rand_aln[i] - lik_ld[i])));
    }
}
