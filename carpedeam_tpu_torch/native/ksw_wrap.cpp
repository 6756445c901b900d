// Wrapped-scoring banded nucleotide alignment for the linclust align
// stage (the guided workflow runs `align` with --wrapped-scoring:
// GuidedNuclassembler.cpp:179, BandedNucleotideAligner.cpp:73-240).
//
// This is a SCALAR re-implementation of the exact semantics of the
// vendored ksw2 extension aligner (lib/mmseqs/lib/ksw2/
// ksw2_extz2_sse.cpp) — including the 16-lane band rounding, the
// persistent difference rows with their stale-lane boundary effects,
// the lane-structured row-max tie behaviour and the z-drop rule —
// followed by BandedNucleotideAligner's anchor flow: ungapped wrapped
// local placement, reverse extension from the anchor end, forward
// extension with traceback, identity count over the cigar.
//
// Provenance: `extz_scalar` is an independent scalar re-derivation of the
// SSE kernel's semantics (explicit lane emulation replacing the vector
// ops).  `backtrack` below is a DERIVATIVE of ksw2's `ksw_backtrack`
// (ksw2.h, MIT License, Copyright (c) 2018- Dana-Farber Cancer
// Institute, 2017-2018 Broad Institute, Inc.) specialised to
// is_rot=1/is_rev=0/with_N=0 — the traceback state machine follows that
// function's structure because byte-identical cigars (and therefore
// byte-identical final FASTA) require its exact tie behaviour.  Used and
// redistributed under the MIT license terms; see
// lib/mmseqs/lib/ksw2/LICENSE.txt in the reference distribution.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t NEG_INF = -0x40000000;

struct Extz {
    uint32_t max = 0;
    int zdropped = 0;
    int max_q = -1, max_t = -1;
    int mqe = NEG_INF, mqe_t = -1;
    int mte = NEG_INF, mte_q = -1;
    int score = NEG_INF;
    std::vector<uint32_t> cigar;
};

inline int apply_zdrop(Extz &ez, int32_t H, int r, int t, int zdrop,
                       int e) {
    if (H > (int32_t)ez.max) {
        ez.max = H;
        ez.max_t = t;
        ez.max_q = r - t;
    } else if (t >= ez.max_t && r - t >= ez.max_q) {
        int tl = t - ez.max_t, ql = (r - t) - ez.max_q;
        int l = tl > ql ? tl - ql : ql - tl;
        if (zdrop >= 0 && (int32_t)ez.max - H > zdrop + l * e) {
            ez.zdropped = 1;
            return 1;
        }
    }
    return 0;
}

inline void push_cigar(std::vector<uint32_t> &cig, uint32_t op,
                       uint32_t len) {
    if (cig.empty() || op != (cig.back() & 0xF))
        cig.push_back(len << 4 | op);
    else
        cig.back() += len << 4;
}

// ksw_backtrack with is_rot=1, is_rev=0, with_N=0 — derivative of ksw2's
// MIT-licensed ksw_backtrack (see provenance note in the file header)
void backtrack(const std::vector<uint8_t> &p, const std::vector<int> &off,
               const std::vector<int> &off_end, int n_col, int i0, int j0,
               std::vector<uint32_t> &cigar) {
    int i = i0, j = j0, state = 0;
    cigar.clear();
    while (i >= 0 && j >= 0) {
        int force_state = -1;
        int r = i + j;
        if (i < off[r]) force_state = 2;
        if (i > off_end[r]) force_state = 1;
        uint32_t tmp = force_state < 0
                           ? p[(size_t)r * n_col + (i - off[r])] : 0;
        if (state == 0) state = tmp & 7;
        else if (!(tmp >> (state + 2) & 1)) state = 0;
        if (state == 0) state = tmp & 7;
        if (force_state >= 0) state = force_state;
        if (state == 0) { push_cigar(cigar, 0, 1); --i; --j; }
        else if (state == 1) { push_cigar(cigar, 2, 1); --i; }
        else { push_cigar(cigar, 1, 1); --j; }
    }
    if (i >= 0) push_cigar(cigar, 2, i + 1);
    if (j >= 0) push_cigar(cigar, 1, j + 1);
    // reverse (is_rev == 0)
    for (size_t a = 0, b = cigar.size(); a + 1 < b; a++, b--)
        std::swap(cigar[a], cigar[b - 1]);
}

// Scalar replica of ksw_extz2_sse (match +2 / mismatch -3, wildcard
// code 4 scores 0; KSW_EZ_EXTZ_ONLY always set; score_only toggles the
// cigar matrix).  Band w = 64; gap cost gapo + l*gape.
void extz_scalar(int qlen, const uint8_t *query, int tlen,
                 const uint8_t *target, int q, int e, int w, int zdrop,
                 bool score_only, Extz &ez) {
    ez = Extz();
    if (qlen <= 0 || tlen <= 0) return;
    const int qe = q + e;
    const int sc_mch = 2, sc_mis = -3, wildcard = 4;
    const int max_sc_cap = sc_mch + 2 * qe;
    if (w < 0) w = tlen > qlen ? tlen : qlen;
    const int wl = w, wr = w;
    const int tlen_ = (tlen + 15) / 16;
    int n_col_ = qlen < tlen ? qlen : tlen;
    n_col_ = ((n_col_ < w + 1 ? n_col_ : w + 1) + 15) / 16 + 1;
    const int qlen_ = (qlen + 15) / 16;

    // persistent difference rows + score row, zero-initialised like the
    // reference's kcalloc block (stale lanes persist across rows)
    std::vector<int8_t> u((size_t)tlen_ * 16, 0), v(u), x(u), y(u), s(u);
    std::vector<uint8_t> sf((size_t)tlen_ * 16, 0),
        qr((size_t)qlen_ * 16 + 16, 0);
    std::vector<int32_t> H((size_t)tlen_ * 16, NEG_INF);
    std::vector<uint8_t> p;
    std::vector<int> off, off_end;
    const int n_col16 = n_col_ * 16;
    if (!score_only) {
        p.assign((size_t)(qlen + tlen - 1) * n_col16, 0);
        off.assign(qlen + tlen - 1, 0);
        off_end.assign(qlen + tlen - 1, 0);
    }
    for (int t = 0; t < qlen; t++) qr[t] = query[qlen - 1 - t];
    std::memcpy(sf.data(), target, tlen);

    int last_st = -1, last_en = -1;
    for (int r = 0; r < qlen + tlen - 1; r++) {
        int st = 0, en = tlen - 1;
        if (st < r - qlen + 1) st = r - qlen + 1;
        if (en > r) en = r;
        if (st < (r - wr + 1) >> 1) st = (r - wr + 1) >> 1;
        if (en > (r + wl) >> 1) en = (r + wl) >> 1;
        if (st > en) { ez.zdropped = 1; break; }
        const int st0 = st, en0 = en;
        st = st / 16 * 16;
        en = (en + 16) / 16 * 16 - 1;
        // boundary conditions
        int8_t x1, v1;
        if (st > 0) {
            if (st - 1 >= last_st && st - 1 <= last_en) {
                x1 = x[st - 1];
                v1 = v[st - 1];
            } else x1 = v1 = 0;
        } else { x1 = 0; v1 = r ? q : 0; }
        if (en >= r) { y[r] = 0; u[r] = r ? q : 0; }
        // scores: 16-wide stores from st0 (overwrites up to the block end)
        {
            const int64_t qoff = (int64_t)qlen - 1 - r;  // qrr = qr + qoff
            for (int t0 = st0; t0 <= en0; t0 += 16)
                for (int k = 0; k < 16; k++) {
                    const int t = t0 + k;
                    if ((size_t)t >= sf.size()) break;
                    const uint8_t a = sf[(size_t)t];
                    const int64_t qi = qoff + t;
                    const uint8_t b =
                        (qi >= 0 && (size_t)qi < qr.size()) ? qr[qi] : 0;
                    int sc = (a == b) ? sc_mch : sc_mis;
                    if (a == wildcard || b == wildcard) sc = 0;
                    s[(size_t)t] = (int8_t)sc;
                }
        }
        // core loop over the 16-aligned band, contiguous t with carries
        {
            int8_t carry_x = x1, carry_v = v1;
            if (!score_only) { off[r] = st; off_end[r] = en; }
            uint8_t *pr = score_only ? nullptr
                                     : p.data() + (size_t)r * n_col16;
            // exact 8-bit lane arithmetic (the SIMD adds/subs wrap and
            // the max/min mix signed (epi8) and unsigned (epu8) compares)
            auto add8 = [](int8_t a, int8_t b) {
                return (int8_t)((uint8_t)a + (uint8_t)b);
            };
            auto sub8 = [](int8_t a, int8_t b) {
                return (int8_t)((uint8_t)a - (uint8_t)b);
            };
            const int8_t qe2_8 = (int8_t)(2 * qe);
            const int8_t cap8 = (int8_t)max_sc_cap;
            for (int t = st; t <= en && (size_t)t < u.size(); t++) {
                const int8_t xt1 = carry_x, vt1 = carry_v;
                carry_x = x[t];
                carry_v = v[t];
                const int8_t ut = u[t];
                int8_t z = add8(s[t], qe2_8);
                const int8_t a = add8(xt1, vt1);
                const int8_t b = add8(y[t], ut);
                uint8_t d = 0;
                if (!score_only) {
                    d = (a > z) ? 1 : 0;          // signed epi8
                    if (z < a) z = a;             // signed max
                    if (b > z) d = 2;             // signed cmpgt
                } else {
                    if (z < a) z = a;
                }
                if ((uint8_t)z < (uint8_t)b) z = b;          // epu8 max
                if ((uint8_t)z > (uint8_t)cap8) z = cap8;    // epu8 min
                u[t] = sub8(z, vt1);
                v[t] = sub8(z, ut);
                const int8_t z2 = sub8(z, (int8_t)q);
                const int8_t a2 = sub8(a, z2);
                const int8_t b2 = sub8(b, z2);
                x[t] = (int8_t)(a2 > 0 ? a2 : 0);            // signed
                y[t] = (int8_t)(b2 > 0 ? b2 : 0);
                if (!score_only) {
                    if (a2 > 0) d |= 0x08;
                    if (b2 > 0) d |= 0x10;
                    pr[t - st] = d;
                }
            }
        }
        // exact max with the reference's lane-structured tie behaviour
        int32_t max_H, max_t;
        if (r > 0) {
            max_H = H[en0] = en0 > 0 ? H[en0 - 1] + (int)(uint8_t)u[en0] - qe
                                     : H[en0] + (int)(uint8_t)v[en0] - qe;
            max_t = en0;
            const int en1 = st0 + (en0 - st0) / 4 * 4;
            int32_t laneH[4] = {max_H, max_H, max_H, max_H};
            int32_t laneT[4] = {max_t, max_t, max_t, max_t};
            int t = st0;
            for (; t < en1; t += 4)
                for (int k = 0; k < 4; k++) {
                    H[t + k] += (int32_t)(uint8_t)v[t + k] - qe;
                    if (H[t + k] > laneH[k]) {
                        laneH[k] = H[t + k];
                        laneT[k] = t;       // lane stores the BASE t
                    }
                }
            for (int k = 0; k < 4; k++)
                if (max_H < laneH[k]) { max_H = laneH[k];
                                        max_t = laneT[k] + k; }
            for (; t < en0; t++) {
                H[t] += (int32_t)(uint8_t)v[t] - qe;
                if (H[t] > max_H) { max_H = H[t]; max_t = t; }
            }
        } else {
            H[0] = (int32_t)(uint8_t)v[0] - qe - qe;
            max_H = H[0];
            max_t = 0;
        }
        if (en0 == tlen - 1 && H[en0] > ez.mte) {
            ez.mte = H[en0];
            ez.mte_q = r - en;
        }
        if (r - st0 == qlen - 1 && H[st0] > ez.mqe) {
            ez.mqe = H[st0];
            ez.mqe_t = st0;
        }
        if (apply_zdrop(ez, max_H, r, max_t, zdrop, e)) break;
        if (r == qlen + tlen - 2 && en0 == tlen - 1)
            ez.score = H[tlen - 1];
        last_st = st;
        last_en = en;
    }
    if (!score_only && ez.max_t >= 0 && ez.max_q >= 0)
        backtrack(p, off, off_end, n_col16, ez.max_t, ez.max_q, ez.cigar);
}

// computeSubstitutionAlignment (local max-subarray, exact update rules)
struct LocalAln {
    int startPos = -1, endPos = -1;
    int score = 0;
    int diagonal = 0;
    int dist = 0;
};

LocalAln local_scan(const uint8_t *q5, const uint8_t *t5, int n) {
    LocalAln out;
    int maxScore = 0, maxEnd = 0, maxStart = 0, minPos = -1, score = 0;
    for (int pos = 0; pos < n; pos++) {
        const int curr =
            (q5[pos] == t5[pos] && q5[pos] < 4) ? 2 : -3;
        score += curr;
        const bool isMin = score <= 0;
        if (isMin) { score = 0; minPos = pos; }
        if (score > maxScore) {
            maxScore = score;
            maxEnd = pos;
            maxStart = minPos + 1;
        }
    }
    out.startPos = maxStart;
    out.endPos = maxEnd;
    out.score = maxScore;
    return out;
}

}  // namespace

extern "C" {

// BandedNucleotideAligner::align with wrappedScoring=true, replicated
// over 5-letter codes.  q2 = DOUBLED strand-corrected query codes
// (len 2L); out[8] = score, qstart, qend, tstart, tend, aaIds, alnLen,
// used_shortcut.  Returns 1 when an alignment was produced.
int64_t wrapped_banded_align(
    const uint8_t *q2, int64_t L2, const uint8_t *t5, int64_t tlen,
    int64_t diag_u, int64_t gapo, int64_t gape, int64_t zdrop,
    int64_t *out)
{
    const int64_t L = L2 / 2;
    // computeUngappedWrappedAlignment: best local placement
    LocalAln best;
    const int n = (int)(tlen < L ? tlen : L);
    for (int64_t d = 1; (-d * 65536 + diag_u) > -tlen; d++) {
        const int64_t rd = (-d * 65536 + diag_u) + L;
        if (rd < 0 || rd >= L2) continue;
        LocalAln tmp = local_scan(q2 + rd, t5, n);
        tmp.diagonal = (int)rd;
        tmp.dist = (int)(rd < 0 ? -rd : rd);
        if (tmp.score > best.score) best = tmp;
    }
    for (int64_t d = 0; (d * 65536 + diag_u) < L; d++) {
        const int64_t rd = d * 65536 + diag_u;
        if (rd < 0 || rd >= L2) continue;
        LocalAln tmp = local_scan(q2 + rd, t5, n);
        tmp.diagonal = (int)rd;
        tmp.dist = (int)(rd < 0 ? -rd : rd);
        if (tmp.score > best.score) best = tmp;
    }
    // diagonal >= 0 here always
    const int64_t qU0 = best.startPos + best.dist;
    const int64_t qU1 = best.endPos + best.dist;
    const int64_t tU0 = best.startPos;
    const int64_t tU1 = best.endPos;

    if (qU1 - qU0 == L - 1 && tU0 == 0 && tU1 == tlen - 1) {
        int64_t ids = 0;
        for (int64_t i = qU0; i <= qU1; i++)
            ids += q2[i] == t5[tU0 + (i - qU0)];
        out[0] = best.score;
        out[1] = qU0; out[2] = qU1;
        out[3] = tU0; out[4] = tU1;
        out[5] = ids;
        out[6] = L;           // backtrace = origQueryLen M's
        out[7] = 1;
        return 1;
    }

    // reversed sequences (plain order reversal, not complement)
    std::vector<uint8_t> qrev((size_t)L2), trev((size_t)tlen);
    for (int64_t i = 0; i < L2; i++) qrev[i] = q2[L2 - 1 - i];
    for (int64_t i = 0; i < tlen; i++) trev[i] = t5[tlen - 1 - i];

    const int64_t qStartRev = (L2 - qU1) - 1;
    const int64_t tStartRev = (tlen - tU1) - 1;
    int64_t qRevLen = L2 - qStartRev;
    if (qRevLen > L) qRevLen = L;

    Extz ez;
    extz_scalar((int)qRevLen, qrev.data() + qStartRev,
                (int)(tlen - tStartRev), trev.data() + tStartRev,
                (int)gapo, (int)gape, 64, (int)zdrop, true, ez);

    const int64_t qStartPos = L2 - (qStartRev + ez.max_q) - 1;
    const int64_t tStartPos = tlen - (tStartRev + ez.max_t) - 1;

    int64_t qLenToAlign = L2 - qStartPos;
    if (qLenToAlign > L) qLenToAlign = L;
    Extz ezAlign;
    extz_scalar((int)qLenToAlign, q2 + qStartPos,
                (int)(tlen - tStartPos), t5 + tStartPos,
                (int)gapo, (int)gape, 64, (int)zdrop, false, ezAlign);

    std::vector<uint32_t> cig;
    if (ez.max_q > ezAlign.max_q && ez.max_t > ezAlign.max_t) {
        Extz ezR;
        extz_scalar((int)qRevLen, qrev.data() + qStartRev,
                    (int)(tlen - tStartRev), trev.data() + tStartRev,
                    (int)gapo, (int)gape, 64, (int)zdrop, false, ezR);
        cig.assign(ezR.cigar.rbegin(), ezR.cigar.rend());
        ezAlign.max = ezR.max;          // result fields from this run
        // NOTE: the reference keeps ezAlign's max_q/max_t for the end
        // coordinates in this branch (BandedNucleotideAligner.cpp:
        // 191-216 overwrites ezAlign via the rerun) — replicate by
        // taking coordinates from the rerun as well
        ezAlign.max_q = ezR.max_q;
        ezAlign.max_t = ezR.max_t;
    } else {
        cig = ezAlign.cigar;
    }

    const int64_t qEndPos = qStartPos + ezAlign.max_q;
    const int64_t tEndPos = tStartPos + ezAlign.max_t;

    // identity + backtrace length over the cigar
    int64_t ids = 0, aln_len = 0;
    {
        int64_t tp = tStartPos, qp = qStartPos;
        for (uint32_t c : cig) {
            const uint32_t op = c & 0xF;
            const uint32_t len = c >> 4;
            for (uint32_t i = 0; i < len; i++) {
                if (op == 0) {
                    if (tp >= 0 && tp < tlen && qp >= 0 && qp < L2)
                        ids += t5[tp] == q2[qp];
                    qp++; tp++; aln_len++;
                } else if (op == 1) { qp++; aln_len++; }
                else { tp++; aln_len++; }
            }
        }
    }
    out[0] = (int64_t)ezAlign.max;
    out[1] = qStartPos; out[2] = qEndPos;
    out[3] = tStartPos; out[4] = tEndPos;
    out[5] = ids;
    out[6] = aln_len;
    out[7] = 0;
    return 1;
}

}  // extern "C"

extern "C" {

// test shim for the golden harness (tools/ksw_golden.cpp): exposes the
// scalar extz replica directly
void extz_scalar_c(int qlen, const uint8_t *query, int tlen,
                   const uint8_t *target, int q, int e, int w, int zdrop,
                   int score_only, int *max, int *max_q, int *max_t,
                   int *zdropped, uint32_t *cigar, int *n_cigar) {
    Extz ez;
    extz_scalar(qlen, query, tlen, target, q, e, w, zdrop,
                score_only != 0, ez);
    *max = (int)ez.max;
    *max_q = ez.max_q;
    *max_t = ez.max_t;
    *zdropped = ez.zdropped;
    *n_cigar = (int)ez.cigar.size();
    for (size_t i = 0; i < ez.cigar.size(); i++) cigar[i] = ez.cigar[i];
}

}  // extern "C"
