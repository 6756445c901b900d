// Greedy splice rounds for read-phase extension and contig-phase merging.
//
// C++ engine for the per-query greedy loops of
// stages/read_assembly.py:292-399 and stages/contig_merge.py:293-388
// (reference semantics: src/assembler/ancientReadsResults.cpp:374-546 and
// ancientContigsResults.cpp:280-473).  The batched initial scoring stays in
// ops/extension_batch.py (device/NumPy); this engine consumes its per-record
// outputs and runs ONLY the sequential greedy rounds: priority-queue pops,
// left/right splicing, diagonal re-alignment of deferred candidates,
// consensus-frame identity updates and damage-likelihood re-scoring.
//
// Exactness contract (the Python loops remain the oracle, pinned by
// tests/test_native_greedy.py):
//   * float steps replicate NumPy's f32 ops (seqId ratios, realign denom);
//   * likelihood sums use the reference's exact precision: sequential
//     80-bit (long double) accumulation of double per-column logs with f32
//     penalty terms and an expl ratio (nuclassembleUtil.cpp:212-341) —
//     last-ulp sLenNorm distinctions decide queue ties at 5M scale;
//     np_pairwise_sum below remains for the Beta-queue contig path;
//   * the priority queue is std::priority_queue (the Python CppPriorityQueue
//     replicates libstdc++'s heap, so pop order incl. ties is identical);
//   * lgamma/log/exp go through libm exactly like CPython's math module.
//
// Queries are independent (extension reads only the immutable input DB), so
// the engine parallelises over queries with OpenMP — same decomposition as
// the reference's `#pragma omp parallel for` over queries.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct GTables {
    uint8_t code[256];        // 5-letter fold A0 C1 T2 G3 X4
    uint8_t revcomp_n[256];   // char -> complement char via "ACTGN" decode
    uint8_t ry[256];
    uint8_t acgt[256];
    GTables() {
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
const GTables GT;

// numpy's pairwise_sum_DOUBLE for a contiguous f64 buffer (PW_BLOCKSIZE=128);
// no longer on the reads-likelihood path (that is exact long double now) but
// kept for any future NumPy-bit-matching need
[[maybe_unused]] double np_pairwise_sum(const double *a, int64_t n) {
    if (n < 8) {
        double res = 0.;
        for (int64_t i = 0; i < n; i++) res += a[i];
        return res;
    } else if (n <= 128) {
        double r[8];
        for (int k = 0; k < 8; k++) r[k] = a[k];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int k = 0; k < 8; k++) r[k] += a[i + k];
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return np_pairwise_sum(a, n2) + np_pairwise_sum(a + n2, n - n2);
}

struct Cand {
    int64_t tid;
    uint32_t tkey;
    int64_t qstart, qend, qlen, tstart, tend, tlen, aln_len;
    double seq_id, ry_seq_id;
    double s1;            // s_len_norm (reads) / deam_match (contigs)
    int64_t aln_len_cons; // contigs
    uint8_t is_rev;       // contigs (reads path is forward-only)
};

// strand-corrected target byte accessor (contig targets may be revcomp'd)
struct Tgt {
    const uint8_t *base;
    int64_t tl;
    bool rev;
    inline uint8_t at(int64_t p) const {
        return rev ? GT.revcomp_n[base[tl - 1 - p]] : base[p];
    }
};

struct ReadsLess {  // queue ordered by sLenNorm
    bool operator()(const Cand *a, const Cand *b) const {
        return a->s1 < b->s1;
    }
};

// CompareNuclResultByScoreContigs (ancientContigsResults.cpp:25-70),
// transcribed with the reference's EXACT overload resolution: libgab.h's
// `using namespace std` makes lgamma/log of the FLOAT alpha/beta sums
// resolve to lgammaf/logf (only log(idx+1), an integral argument, stays
// double).  The f32-precision lgamma moves p by ~1e-5, which decides
// gray-zone [0.45, 0.55] outcomes — one such pair flipped a 5M-scale
// merge pick before this transcription.
struct BetaLess {
    bool operator()(const Cand *r1, const Cand *r2) const {
        const float mm1 = (float)r1->aln_len_cons - (float)r1->s1;
        const float mm2 = (float)r2->aln_len_cons - (float)r2->s1;
        const float alpha1 = mm1 + 1.0f;
        const float alpha2 = mm2 + 1.0f;
        const float beta1 = (float)r1->s1 + 1.0f;
        const float beta2 = (float)r2->s1 + 1.0f;
        const double log_c =
            (double)((lgammaf(beta1 + beta2) + lgammaf(alpha1 + beta1)) -
                     (lgammaf(alpha1 + beta1 + beta2) + lgammaf(beta1)));
        double log_r = 0.0, p = 0.0;
        for (size_t idx = 0; (float)idx < alpha2; idx++) {
            p += exp(log_r + log_c);
            log_r = (double)(logf(alpha1 + (float)idx) +
                             logf(beta2 + (float)idx)) -
                    (log((double)(idx + 1)) +
                     (double)logf((float)idx + alpha1 + beta1 + beta2)) +
                    log_r;
        }
        if (p < 0.45) return true;
        if (p > 0.55) return false;
        if (r1->aln_len_cons < r2->aln_len_cons) return true;
        if (r1->aln_len_cons > r2->aln_len_cons) return false;
        return true;
    }
};

// DistanceCalculator::ungappedAlignmentByDiagonal END_TO_END
// (stages/read_assembly.py::_ungapped_realign)
struct Realn {
    int64_t start, end, dlen, dist;
};
inline Realn ungapped_realign(const uint8_t *query, int64_t qlen,
                              const Tgt &t, int64_t diag) {
    const int64_t dist = diag < 0 ? -diag : diag;
    int64_t n;
    if (diag >= 0 && dist < qlen) {
        n = t.tl < qlen - dist ? t.tl : qlen - dist;
    } else if (diag < 0 && dist < t.tl) {
        n = (t.tl - dist) < qlen ? (t.tl - dist) : qlen;
    } else {
        return {-1, -1, 0, dist};
    }
    return {0, n - 1, n, dist};
}

// updateSeqIdConsensusReads for one candidate against the SAFE consensus
// (query copied into the middle third of a 3L 'N' buffer); returns side:
// 0 none, 1 left, 2 right, and total columns.  Mutates c.seq_id/ry_seq_id.
inline void seq_id_vs_consensus(Cand *c, const uint8_t *query, int64_t qlen,
                                const Tgt &t, int64_t *total_o,
                                int *side_o) {
    const bool right_start = c->tstart == 0 && c->qend == qlen - 1;
    const bool left_start = c->qstart == 0 && c->tend == c->tlen - 1;
    const int64_t offset = c->tlen - c->aln_len;
    const int64_t cons_start = qlen - offset;
    *total_o = 0;
    *side_o = 0;
    if (!(left_start || right_start) || cons_start < 0) return;
    *side_o = left_start ? 1 : 2;
    const int64_t base = left_start ? cons_start
                                    : 3 * qlen - (c->tlen + cons_start);
    int64_t total = 0, idc = 0, ryc = 0;
    for (int64_t i = 0; i < c->tlen; i++) {
        const int64_t cp = base + i;
        if (cp < 0 || cp >= 3 * qlen) continue;
        const uint8_t cons = (cp >= qlen && cp < 2 * qlen)
                                 ? query[cp - qlen] : (uint8_t)'N';
        const uint8_t tb = t.at(i);
        if (cons == 'N' || tb == 'N') continue;
        total++;
        idc += cons == tb;
        ryc += GT.ry[cons] == GT.ry[tb];
    }
    *total_o = total;
    if (total == 0) return;
    c->seq_id = (double)((float)idc / (float)total);
    c->ry_seq_id = (double)((float)ryc / (float)total);
}

// calcLikelihoodConsensus against the SAFE consensus
// (ops/likelihood.py::calc_likelihood_consensus)
inline void calc_likelihood(const Cand *c, const uint8_t *query,
                            int64_t qlen, const Tgt &t, const double *logm,
                            int64_t max_aln, double log_rand,
                            double log_excess, std::vector<double> &buf,
                            double *sln_o, double *ratio_o) {
    const bool right_start = c->tstart == 0 && c->qend == qlen - 1;
    const bool left_start = c->qstart == 0 && c->tend == c->tlen - 1;
    const int64_t offset = c->tlen - c->aln_len;
    const int64_t cons_start = qlen - offset;
    int64_t ac = 0;
    if ((left_start || right_start) && cons_start >= 0) {
        const int64_t base = left_start
                                 ? cons_start
                                 : 3 * qlen - (c->tlen + cons_start);
        buf.clear();
        int64_t t_rank = -1;
        for (int64_t i = 0; i < c->tlen; i++) {
            const uint8_t tb = t.at(i);
            const bool t_nn = tb != 'N';
            if (t_nn) t_rank++;
            const int64_t cp = base + i;
            if (cp < 0 || cp >= 3 * qlen) continue;
            const uint8_t cons = (cp >= qlen && cp < 2 * qlen)
                                     ? query[cp - qlen] : (uint8_t)'N';
            if (!t_nn || cons == 'N') continue;
            int64_t lay = t_rank < 5 ? t_rank : 5;
            const int64_t from_end = t_rank - (c->tlen - 5);
            if (from_end >= 0) lay = 6 + from_end;
            buf.push_back(logm[(lay * 4 + GT.acgt[cons]) * 4 + GT.acgt[tb]]);
        }
        ac = (int64_t)buf.size();
    }
    // exact reference precision (nuclassembleUtil.cpp:212-341): sequential
    // 80-bit accumulation of the double per-column logs; f32 penalty terms
    // (log_rand/log_excess arrive as logf values); ratio through expl
    long double lm = 0.0L;
    for (int64_t i = 0; i < ac; i++) lm += buf[i];
    const int64_t excess = max_aln - ac;
    lm += (long double)((float)excess * (float)log_excess);
    const double rand_aln = (double)((float)max_aln * (float)log_rand);
    *sln_o = (double)lm;
    *ratio_o = (double)(1.0L / (1.0L + expl((long double)rand_aln - lm)));
}

// growable query buffer with left headroom
struct QBuf {
    std::vector<uint8_t> buf;
    int64_t start, len;
    void init(const uint8_t *q, int64_t L, int64_t cap_side) {
        buf.assign((size_t)(2 * cap_side + L), 0);
        start = cap_side;
        len = L;
        memcpy(buf.data() + start, q, (size_t)L);
    }
    const uint8_t *data() const { return buf.data() + start; }
    void append_right(const Tgt &t, int64_t from) {  // t[from:]
        for (int64_t p = from; p < t.tl; p++)
            buf[(size_t)(start + len + p - from)] = t.at(p);
        len += t.tl - from;
    }
    void prepend_left(const Tgt &t, int64_t count) {  // t[:count]
        start -= count;
        for (int64_t p = 0; p < count; p++)
            buf[(size_t)(start + p)] = t.at(p);
        len += count;
    }
};

struct RowArrays {
    const int64_t *tid;
    const uint32_t *tkey;
    const int32_t *qs, *qe, *ts, *te, *tl, *alen;
    const double *seq_id, *ry, *s1, *sratio;
    const uint8_t *qok;
    const uint8_t *is_rev;       // contigs only (null for reads)
    const int64_t *aln_len_cons; // contigs only (null for reads)
};

template <typename Queue>
void build_cands(const RowArrays &R, int64_t r0, int64_t r1,
                 const uint8_t *data, const int64_t *offsets,
                 const int64_t *lengths, int64_t L,
                 std::vector<Cand> &cands, std::vector<Tgt> &tgts,
                 Queue &queue) {
    cands.clear();
    tgts.clear();
    cands.reserve((size_t)(r1 - r0));
    tgts.reserve((size_t)(r1 - r0));
    for (int64_t r = r0; r < r1; r++) {
        Cand c;
        c.tid = R.tid[r];
        c.tkey = R.tkey[r];
        c.qstart = R.qs[r]; c.qend = R.qe[r]; c.qlen = L;
        c.tstart = R.ts[r]; c.tend = R.te[r]; c.tlen = R.tl[r];
        c.aln_len = R.alen[r];
        c.seq_id = R.seq_id[r];
        c.ry_seq_id = R.ry[r];
        c.s1 = R.s1[r];
        c.aln_len_cons = R.aln_len_cons ? R.aln_len_cons[r] : 0;
        c.is_rev = R.is_rev ? R.is_rev[r] : 0;
        cands.push_back(c);
        tgts.push_back({data + offsets[c.tid], c.tlen, c.is_rev != 0});
    }
    for (size_t k = 0; k < cands.size(); k++)
        if (R.qok[r0 + (int64_t)k]) queue.push(&cands[k]);
}

// selectNuclFragmentToExtend{Reads,Contigs}: pop until a usable candidate
template <typename Queue>
Cand *select_best(Queue &queue, uint32_t qkey, int64_t qlen_cur) {
    while (!queue.empty()) {
        Cand *c = queue.top();
        queue.pop();
        const bool rs = c->tstart == 0 && c->tend != c->tlen - 1;
        const bool ls = c->qstart == 0 && c->qend != c->qlen - 1;
        if ((rs || ls) && !(c->tstart == 0 && c->qstart == 0) &&
            c->tkey != qkey)
            return c;
    }
    return nullptr;
}

}  // namespace

// mode 0 = reads (likelihood re-scoring), 1 = contigs (Beta queue,
// threshold-only re-queue).  Writes each extended query's bytes into
// arena[arena_off[j] ...] and its length into out_len[j] (0 = unchanged).
template <typename Queue>
static void greedy_rounds_impl(
    int mode, const uint8_t *data, const int64_t *offsets,
    const int64_t *lengths, const uint32_t *keys, int64_t n_query,
    const int64_t *q_ids, const int64_t *row_ptr, const RowArrays &R,
    const int64_t *max_left_in, const int64_t *max_right_in,
    const double *logm, double seq_id_thr, double ry_thr, double lik_thr,
    double log_rand, double log_excess, int64_t max_seq_len,
    uint8_t *arena, const int64_t *arena_off, int64_t *out_len)
{
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<Cand> cands;
        std::vector<Tgt> tgts;
        std::vector<Cand *> deferred;
        std::vector<double> likbuf;
        QBuf qb;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
        for (int64_t j = 0; j < n_query; j++) {
            out_len[j] = 0;
            const int64_t i = q_ids[j];
            const uint32_t qkey = keys[i];
            const int64_t L = lengths[i];
            const int64_t r0 = row_ptr[j], r1 = row_ptr[j + 1];
            Queue queue;
            build_cands(R, r0, r1, data, offsets, lengths, L, cands, tgts,
                        queue);
            if (queue.empty()) continue;

            int64_t cap_side = 0;
            for (int64_t r = r0; r < r1; r++) cap_side += R.tl[r];
            if (cap_side > max_seq_len) cap_side = max_seq_len;
            qb.init(data + offsets[i], L, cap_side);
            int64_t qlen_cur = L;
            int64_t max_left = max_left_in[j], max_right = max_right_in[j];

            bool could_extend = false;
            bool broke_on_maxlen = false;
            while (!queue.empty() && !broke_on_maxlen) {
                int64_t left_off = 0, right_off = 0;
                deferred.clear();
                while (!queue.empty()) {
                    Cand *best = select_best(queue, qkey, qlen_cur);
                    if (!best) break;
                    const int64_t tlen = best->tlen;
                    if (best->tstart == 0) {
                        if (tlen - (best->tend + 1) <= right_off) continue;
                    } else if (best->qstart == 0) {
                        if (best->tstart <= left_off) continue;
                    }
                    const Tgt &tg = tgts[(size_t)(best - cands.data())];
                    if (best->tstart == 0 && best->qend == qlen_cur - 1) {
                        if (right_off > 0) { deferred.push_back(best);
                                             continue; }
                        const int64_t frag = tlen - (best->tend + 1);
                        if (qb.len + frag >= max_seq_len) {
                            broke_on_maxlen = !queue.empty();
                            break;
                        }
                        qb.append_right(tg, best->tend + 1);
                        right_off += frag;
                    } else if (best->qstart == 0 &&
                               best->tend == tlen - 1) {
                        if (left_off > 0) { deferred.push_back(best);
                                            continue; }
                        const int64_t frag = best->tstart;
                        if (qb.len + frag >= max_seq_len) {
                            broke_on_maxlen = !queue.empty();
                            break;
                        }
                        qb.prepend_left(tg, best->tstart);
                        left_off += frag;
                    }
                }
                if (left_off > 0 || right_off > 0) could_extend = true;
                if (broke_on_maxlen) break;
                qlen_cur = qb.len;

                // re-align deferred candidates against the grown query
                for (Cand *c : deferred) {
                    const int64_t diag = (c->qstart + left_off) - c->tstart;
                    const Tgt &tg = tgts[(size_t)(c - cands.data())];
                    const Realn ra =
                        ungapped_realign(qb.data(), qlen_cur, tg, diag);
                    if (diag >= 0) {
                        c->qstart = ra.start + ra.dist;
                        c->qend = ra.end + ra.dist;
                        c->tstart = ra.start;
                        c->tend = ra.end;
                    } else {
                        c->qstart = ra.start;
                        c->qend = ra.end;
                        c->tstart = ra.start + ra.dist;
                        c->tend = ra.end + ra.dist;
                    }
                    int64_t idc = 0;
                    if (c->qend > c->qstart) {
                        // python slices clamp: window length bounded by
                        // the query/target tails
                        int64_t w = c->qend - c->qstart;
                        if (c->qstart + w > qlen_cur) w = qlen_cur - c->qstart;
                        if (c->tstart + w > c->tlen) w = c->tlen - c->tstart;
                        for (int64_t p = 0; p < w; p++)
                            idc += qb.data()[c->qstart + p] ==
                                   tg.at(c->tstart + p);
                    }
                    const float denom = (float)c->qend - (float)c->qstart;
                    c->seq_id = denom != 0.0f
                                    ? (double)((float)idc / denom) : 0.0;
                    c->qlen = qlen_cur;
                    c->aln_len = ra.dlen;
                    if (mode == 1) {
                        // getRYSeqId over the realigned window
                        const int64_t a2 = c->aln_len;
                        int64_t nq = qlen_cur - c->qstart;
                        if (nq > a2) nq = a2;
                        if (nq < 0) nq = 0;
                        int64_t nt = c->tlen - c->tstart;
                        if (nt > a2) nt = a2;
                        if (nt < 0) nt = 0;
                        const int64_t n2 = nq < nt ? nq : nt;
                        if (a2 > 0 && n2 == a2) {
                            int64_t ryc = 0;
                            for (int64_t p = 0; p < a2; p++)
                                ryc += GT.ry[qb.data()[c->qstart + p]] ==
                                       GT.ry[tg.at(c->tstart + p)];
                            c->ry_seq_id =
                                (double)((float)ryc / (float)a2);
                        } else {
                            c->ry_seq_id = 0.0;
                        }
                        // deamMatch / alnLengthCons intentionally stale
                        if (c->seq_id >= seq_id_thr &&
                            c->ry_seq_id >= ry_thr)
                            queue.push(c);
                    }
                }
                if (mode == 0) {
                    // consensus-frame identity update (tracks max side
                    // overlaps), THEN likelihood re-scoring — two separate
                    // passes like the oracle
                    for (Cand *c : deferred) {
                        int64_t total;
                        int side;
                        const Tgt &tg = tgts[(size_t)(c - cands.data())];
                        seq_id_vs_consensus(c, qb.data(), qlen_cur, tg,
                                            &total, &side);
                        if (side == 1 && total > max_left) max_left = total;
                        else if (side == 2 && total > max_right)
                            max_right = total;
                    }
                    for (Cand *c : deferred) {
                        const bool not_inside = c->tlen != c->aln_len;
                        const bool rs = c->tstart == 0;
                        const bool ls = c->qstart == 0;
                        if (c->seq_id >= seq_id_thr && (rs || ls) &&
                            c->tkey != qkey && not_inside) {
                            const int64_t max_aln =
                                (c->qstart == 0 && c->tend == c->tlen - 1)
                                    ? max_left : max_right;
                            const Tgt &tg =
                                tgts[(size_t)(c - cands.data())];
                            double sln, ratio;
                            calc_likelihood(c, qb.data(), qlen_cur, tg,
                                            logm, max_aln, log_rand,
                                            log_excess, likbuf, &sln,
                                            &ratio);
                            c->s1 = sln;
                            if (ratio > lik_thr) queue.push(c);
                        }
                    }
                }
            }
            if (could_extend) {
                out_len[j] = qb.len;
                memcpy(arena + arena_off[j], qb.data(), (size_t)qb.len);
            }
        }
    }
}

extern "C" void greedy_read_rounds(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const uint32_t *keys, int64_t n_query, const int64_t *q_ids,
    const int64_t *row_ptr,
    const int64_t *rows_tid, const uint32_t *rows_tkey,
    const int32_t *rows_qs, const int32_t *rows_qe, const int32_t *rows_ts,
    const int32_t *rows_te, const int32_t *rows_tl, const int32_t *rows_alen,
    const double *rows_seq_id, const double *rows_ry, const double *rows_sln,
    const double *rows_sratio, const uint8_t *rows_qok,
    const int64_t *max_left, const int64_t *max_right, const double *logm,
    double seq_id_thr, double lik_thr, double log_rand, double log_excess,
    int64_t max_seq_len, uint8_t *arena, const int64_t *arena_off,
    int64_t *out_len)
{
    RowArrays R{rows_tid, rows_tkey, rows_qs, rows_qe, rows_ts, rows_te,
                rows_tl, rows_alen, rows_seq_id, rows_ry, rows_sln,
                rows_sratio, rows_qok, nullptr, nullptr};
    greedy_rounds_impl<std::priority_queue<Cand *, std::vector<Cand *>,
                                           ReadsLess>>(
        0, data, offsets, lengths, keys, n_query, q_ids, row_ptr, R,
        max_left, max_right, logm, seq_id_thr, 0.0, lik_thr, log_rand,
        log_excess, max_seq_len, arena, arena_off, out_len);
}

extern "C" void greedy_contig_rounds(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const uint32_t *keys, int64_t n_query, const int64_t *q_ids,
    const int64_t *row_ptr,
    const int64_t *rows_tid, const uint32_t *rows_tkey,
    const int32_t *rows_qs, const int32_t *rows_qe, const int32_t *rows_ts,
    const int32_t *rows_te, const int32_t *rows_tl, const int32_t *rows_alen,
    const double *rows_seq_id, const double *rows_ry,
    const double *rows_deam, const int64_t *rows_alc,
    const uint8_t *rows_is_rev, const uint8_t *rows_qok,
    double merge_thr, double ry_thr, int64_t max_seq_len,
    uint8_t *arena, const int64_t *arena_off, int64_t *out_len)
{
    std::vector<int64_t> z((size_t)n_query, 0);  // max L/R unused here
    RowArrays R{rows_tid, rows_tkey, rows_qs, rows_qe, rows_ts, rows_te,
                rows_tl, rows_alen, rows_seq_id, rows_ry, rows_deam,
                nullptr, rows_qok, rows_is_rev, rows_alc};
    greedy_rounds_impl<std::priority_queue<Cand *, std::vector<Cand *>,
                                           BetaLess>>(
        1, data, offsets, lengths, keys, n_query, q_ids, row_ptr, R,
        z.data(), z.data(), nullptr, merge_thr, ry_thr, 0.0, 0.0, 0.0,
        max_seq_len, arena, arena_off, out_len);
}

// Test probe: evaluate the Beta-queue comparator on raw fields (pins the
// float-lgamma overload transcription; tests/test_contig_phase.py).
extern "C" int beta_less_probe(int64_t alc1, double deam1,
                               int64_t alc2, double deam2)
{
    Cand a, b;
    a.aln_len_cons = alc1; a.s1 = deam1;
    b.aln_len_cons = alc2; b.s1 = deam2;
    return BetaLess()(&a, &b) ? 1 : 0;
}
