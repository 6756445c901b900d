// Native batch kernels for the linclust redundancy-reduction stages.
//
// These collapse the per-record Python loops of stages/linclust.py
// (hamming_wrapped_rescore and align_filter's best-diagonal search) into
// OpenMP loops over all prefilter records, mirroring the NumPy oracle
// bit-for-bit.  The Python loops remain in stages/linclust.py as the
// fallback/oracle; tests pin equality.
//
// Reference roles:
//   - wrapped hamming rescore: rescorediagonal with RESCORE_MODE_HAMMING +
//     --wrapped-scoring (lib/mmseqs/src/alignment/rescorediagonal.cpp:
//     162-167,215-225,243-246,319-331; DistanceCalculator::
//     computeUngappedWrappedAlignment, DistanceCalculator.h:58-92)
//   - align best-diagonal: the `align` stage's end-to-end diagonal
//     re-scoring (two ushort-wrapped candidate diagonals, +2/-3 matrix)
//     ahead of the gapped (banded) rescue.
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// 5-letter fold + complement decode, identical to stages/linclust.py's
// _CHAR_REVCOMP_X (= "ACTGX"[COMPLEMENT_CODE[CHAR_TO_CODE[c]]]) and
// constants.CHAR_TO_CODE (NucleotideMatrix::setupLetterMapping).
struct LcTables {
    uint8_t code[256];
    uint8_t revcomp_x[256];
    LcTables() {
        memset(code, 4, sizeof(code));
        const char *a = "Aa", *c = "CcMmYyHh", *t = "TtUuWw",
                   *g = "GgKkBbDdVvRrSs";
        for (const char *p = a; *p; p++) code[(uint8_t)*p] = 0;
        for (const char *p = c; *p; p++) code[(uint8_t)*p] = 1;
        for (const char *p = t; *p; p++) code[(uint8_t)*p] = 2;
        for (const char *p = g; *p; p++) code[(uint8_t)*p] = 3;
        const char dec_x[6] = "ACTGX";
        static const uint8_t comp[5] = {2, 3, 0, 1, 4};
        for (int i = 0; i < 256; i++)
            revcomp_x[i] = (uint8_t)dec_x[comp[code[i]]];
    }
};
const LcTables LT;

}  // namespace

extern "C" {

// Wrapped hamming rescore, best diagonal per pair.
// out (3 per pair): best_score, best_diag (pre-int16 truncation), valid
// (0 when tlen > qlen: no valid wrapped scoring, record dropped).
void linclust_wrapped_rescore(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const int32_t *qid, const int32_t *tid, const uint16_t *diag_u,
    const uint8_t *rev, int64_t n_pairs, int32_t *out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t p = 0; p < n_pairs; p++) {
        const int64_t qi = qid[p], ti = tid[p];
        const int64_t L = lengths[qi], tlen = lengths[ti];
        int32_t *o = out + 3 * p;
        if (tlen > L) { o[0] = 0; o[1] = 0; o[2] = 0; continue; }
        const uint8_t *q = data + offsets[qi];
        const uint8_t *t = data + offsets[ti];
        const bool is_rev = rev[p] != 0;
        const int64_t du = (int64_t)diag_u[p];
        const int64_t n = tlen;  // min(tlen, L)
        int64_t best_score = 0, best_diag = 0;
        bool first = true;
        // candidate diagonals, same enumeration order as the oracle:
        // negative wraps (d=1..) then non-negative (d=0..)
        auto try_cand = [&](int64_t rd) {
            if (rd < 0 || rd + n > 2 * L) return;
            int64_t sc = 0;
            if (!is_rev) {
                // doubled[i] = q[i % L]
                for (int64_t j = 0; j < n; j++) {
                    int64_t i = rd + j;
                    sc += (q[i >= L ? i - L : i] == t[j]);
                }
            } else {
                // doubled_rev[i] = revcomp_x[q[(2L-1-i) % L]]
                for (int64_t j = 0; j < n; j++) {
                    int64_t i = 2 * L - 1 - (rd + j);
                    sc += (LT.revcomp_x[q[i >= L ? i - L : i]] == t[j]);
                }
            }
            if (first || sc > best_score) { best_score = sc; best_diag = rd; }
            first = false;
        };
        for (int64_t d = 1; (-d * 65536 + du) > -tlen; d++)
            try_cand((-d * 65536 + du) + L);
        for (int64_t d = 0; (d * 65536 + du) < L; d++)
            try_cand(d * 65536 + du);
        o[0] = (int32_t)best_score;
        o[1] = (int32_t)best_diag;
        o[2] = 1;
    }
}

// align stage: end-to-end score on the two candidate real diagonals.
// out (5 per pair): score, cand, n, ids, valid
//   valid 0 = no valid candidate window (record dropped)
//   valid 1 = normal; valid 2 = identity pair (qid == tid)
void linclust_align_best(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const int32_t *qid, const int32_t *tid, const uint16_t *diag_u,
    const uint8_t *rev, int64_t n_pairs, int32_t *out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t p = 0; p < n_pairs; p++) {
        const int64_t qi = qid[p], ti = tid[p];
        const int64_t L = lengths[qi], tlen = lengths[ti];
        int32_t *o = out + 5 * p;
        const bool is_rev = rev[p] != 0;
        if (qi == ti) {
            o[0] = (int32_t)(2 * L); o[1] = 0; o[2] = (int32_t)L;
            o[3] = (int32_t)L; o[4] = 2;
            continue;
        }
        const uint8_t *qraw = data + offsets[qi];
        const uint8_t *t = data + offsets[ti];
        // qb[i] = is_rev ? revcomp_x[qraw[L-1-i]] : qraw[i]
        auto qb = [&](int64_t i) -> uint8_t {
            return is_rev ? LT.revcomp_x[qraw[L - 1 - i]] : qraw[i];
        };
        const int64_t du = (int64_t)diag_u[p];
        bool have = false;
        int64_t b_score = 0, b_cand = 0, b_n = 0, b_ids = 0;
        const int64_t cands[2] = {du - 65536, du};
        for (int k = 0; k < 2; k++) {
            const int64_t cand = cands[k];
            const int64_t dist = cand < 0 ? -cand : cand;
            int64_t n, qoff, toff;
            if (cand >= 0 && dist < L) {
                n = tlen < L - dist ? tlen : L - dist;
                qoff = dist; toff = 0;
            } else if (cand < 0 && dist < tlen) {
                n = (tlen - dist) < L ? tlen - dist : L;
                qoff = 0; toff = dist;
            } else {
                continue;
            }
            int64_t m = 0;
            for (int64_t j = 0; j < n; j++) {
                uint8_t qc = LT.code[qb(qoff + j)];
                uint8_t tc = LT.code[t[toff + j]];
                m += (qc == tc) & (qc < 4);
            }
            int64_t score = 2 * m - 3 * (n - m);
            if (score < 0) score = 0;
            if (!have || score > b_score) {
                int64_t ids = 0;
                for (int64_t j = 0; j < n; j++)
                    ids += (qb(qoff + j) == t[toff + j]);
                b_score = score; b_cand = cand; b_n = n; b_ids = ids;
            }
            have = true;
        }
        if (!have) { o[0] = o[1] = o[2] = o[3] = o[4] = 0; continue; }
        o[0] = (int32_t)b_score; o[1] = (int32_t)b_cand;
        o[2] = (int32_t)b_n; o[3] = (int32_t)b_ids; o[4] = 1;
    }
}

}  // extern "C"

extern "C" {

// CSR -> padded device planes in one pass (the pack_sequences hot path:
// sym/sym_rc/code/code_rc rows, zero-padded to max_len).  Python oracle:
// ops/rescore_tpu.pack_sequences.
void pack_planes(
    const uint8_t *data, const int64_t *offsets, const int64_t *lengths,
    const int64_t *ids, int64_t n, int64_t max_len,
    uint8_t *sym, uint8_t *sym_rc, uint8_t *code, uint8_t *code_rc) {
    const uint8_t *code_of = LT.code;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; i++) {
        const int64_t row = ids ? ids[i] : i;
        const int64_t off = offsets[row];
        const int64_t L = lengths[row] < max_len ? lengths[row] : max_len;
        uint8_t *s = sym + i * max_len, *sr = sym_rc + i * max_len;
        uint8_t *c = code + i * max_len, *cr = code_rc + i * max_len;
        const int64_t full = lengths[row];
        for (int64_t x = 0; x < L; x++) {
            const uint8_t b = data[off + x] & 0xDF;  // _UPPER
            s[x] = b;
            c[x] = code_of[b];
            const uint8_t rb = LT.revcomp_x[data[off + full - 1 - x]];
            sr[x] = rb;
            cr[x] = code_of[rb];
        }
        if (L < max_len) {
            memset(s + L, 0, max_len - L);
            memset(sr + L, 0, max_len - L);
            // oracle pads code via CHAR_TO_CODE[0] == 4 (X)
            memset(c + L, 4, max_len - L);
            memset(cr + L, 4, max_len - L);
        }
    }
}

}  // extern "C"
