// Banded affine-gap nucleotide alignment — native fast path for
// ops/banded_align.py (the ksw2 / BandedNucleotideAligner role in
// linclust's `align` stage, lib/mmseqs/src/alignment/
// BandedNucleotideAligner.cpp:169-195).
//
// Exact port of the NumPy oracle in ops/banded_align.py (row-banded
// Gotoh with the E-state prefix-max recursion and H-source traceback);
// bit-identical results are pinned by tests/test_banded_align.py.
// The Python per-row loop costs ~80 ms per kilobase pair; this runs the
// same DP in ~0.2 ms, which is what makes linclust's gapped rescue
// viable at 1M-read scale (it burned 45 of 205 s at 120k reads).
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {
constexpr int64_t NEG = -100000000;  // matches banded_align.py NEG
}

extern "C" {

// q/t: code arrays (0..4); out[5] = score, q_end, t_end, n_ident, aln_len
void banded_align_one(const uint8_t* q, int64_t nq,
                      const uint8_t* t, int64_t nt,
                      int64_t band, int64_t match, int64_t mismatch,
                      int64_t gapo, int64_t gape, int64_t* out) {
    out[0] = 0; out[1] = -1; out[2] = -1; out[3] = 0; out[4] = 0;
    if (nq == 0 || nt == 0) return;
    const int64_t w = band;
    const int64_t width = 2 * w + 1;

    // score_lut: diagonal = match, then row/col 4 forced to mismatch
    int64_t lut[5][5];
    for (int a = 0; a < 5; ++a)
        for (int b = 0; b < 5; ++b)
            lut[a][b] = (a == b) ? match : mismatch;
    for (int a = 0; a < 5; ++a) { lut[4][a] = mismatch; lut[a][4] = mismatch; }

    std::vector<uint8_t> t_pad(nt + width + 2, 4);
    std::memcpy(t_pad.data(), t, nt);

    std::vector<int64_t> H_prev(width, NEG), F_prev(width, NEG);
    std::vector<int64_t> H_new(width), F_new(width), diag(width), hdf(width);
    H_prev[w] = 0;
    // tb bit layout: bits 0-1 H-source (0 diag, 1 E, 2 F); bit 2 E from
    // E (gap-extend); bit 3 F from F — see banded_align.py
    std::vector<uint8_t> tb((nq + 1) * width, 0);
    for (int64_t d = w + 1; d < width; ++d) {
        H_prev[d] = -(gapo + gape * (d - w));
        tb[d] = (d > w + 1) ? 5 : 1;
    }

    int64_t best_score = NEG, best_qe = -1, best_te = -1;
    int64_t dend0 = nt - 1 + w + 1;  // band cell where j == nt in row 0
    if (dend0 >= 0 && dend0 < width && H_prev[dend0] > best_score) {
        best_score = H_prev[dend0]; best_qe = -1; best_te = nt - 1;
    }

    for (int64_t i = 1; i <= nq; ++i) {
        const int64_t qi = q[i - 1];
        uint8_t* tbi = tb.data() + i * width;
        int64_t run = NEG;  // prefix max of (hdf + gape*d) over d' < d
        int64_t e_prev = NEG, hd_prev = NEG;  // previous column's E / hdf
        for (int64_t d = 0; d < width; ++d) {
            const int64_t j_of = d - w + (i - 1);    // j-1 of diag source
            const bool valid = (j_of >= -1) && (j_of + 1 <= nt);
            const bool diag_ok = (j_of >= 0) && (j_of < nt);
            const int64_t tc = t_pad[j_of < 0 ? 0 : j_of];
            const int64_t dg = diag_ok ? H_prev[d] + lut[qi][tc] : NEG;
            int64_t fn = NEG;
            bool f_ext = false;
            if (d + 1 < width) {
                fn = std::max(H_prev[d + 1] - gapo - gape,
                              F_prev[d + 1] - gape);
                f_ext = (F_prev[d + 1] - gape >=
                         H_prev[d + 1] - gapo - gape) &&
                        (F_prev[d + 1] > NEG / 2);
            }
            if (!valid) { fn = NEG; f_ext = false; }
            const int64_t hd = std::max(dg, fn);
            const int64_t e0 = valid ? run - gapo - gape * d : NEG;
            const int64_t en = std::max(e0, NEG);
            const bool e_ext = (d > 0) &&
                               (e_prev - gape >= hd_prev - gapo - gape) &&
                               (e_prev > NEG / 2);
            if (valid) run = std::max(run, hd + gape * d);
            const int64_t hn = std::max(hd, en);
            uint8_t s = 0;
            if (en > hd) s = 1;
            else if (fn >= hn && fn > dg) s = 2;
            if (e_ext) s |= 4;
            if (f_ext) s |= 8;
            tbi[d] = s;
            diag[d] = dg; F_new[d] = fn; hdf[d] = hd; H_new[d] = hn;
            e_prev = en; hd_prev = hd;
        }
        std::swap(H_prev, H_new);
        std::swap(F_prev, F_new);
        const int64_t dq = nt - i + w;               // cell where j == nt
        if (dq >= 0 && dq < width && H_prev[dq] > best_score) {
            best_score = H_prev[dq]; best_qe = i - 1; best_te = nt - 1;
        }
        if (i == nq) {
            int64_t dmax = -1, cmax = NEG;
            for (int64_t d = 0; d < width; ++d) {
                const int64_t jv = d - w + nq;
                const int64_t c = (jv >= 1 && jv <= nt) ? H_prev[d] : NEG;
                if (dmax < 0 || c > cmax) { cmax = c; dmax = d; }
            }
            if (cmax > best_score) {
                best_score = cmax; best_qe = nq - 1;
                best_te = (dmax - w + nq) - 1;
            }
        }
    }

    if (best_qe < 0 || best_te < 0 || best_score <= 0) {
        out[0] = std::max(best_score, (int64_t)0);
        return;
    }
    // traceback for identities / alignment length
    int64_t i = best_qe + 1;
    int64_t d = (best_te + 1) - i + w;
    int64_t n_ident = 0, aln_len = 0;
    int state = 0;  // 0 = H, 1 = E, 2 = F (gap runs honour extend bits)
    int64_t guard = 4 * (nq + nt) + 8;
    while (i > 0 && (d - w + i) > 0 && guard > 0) {
        --guard;
        const uint8_t cell = tb[i * width + d];
        if (state == 0) {
            const uint8_t s = cell & 3;
            if (s == 0) {
                ++aln_len;
                const int64_t j = d - w + i;
                if (j > 0 && j <= nt && q[i - 1] == t[j - 1] &&
                    q[i - 1] < 4)
                    ++n_ident;
                --i;
            } else {
                state = s;
            }
        } else if (state == 1) {
            ++aln_len;
            const bool ext = cell & 4;
            --d;
            state = ext ? 1 : 0;
        } else {
            ++aln_len;
            const bool ext = cell & 8;
            --i; ++d;
            state = ext ? 2 : 0;
        }
    }
    out[0] = best_score; out[1] = best_qe; out[2] = best_te;
    out[3] = n_ident; out[4] = aln_len;
}

}  // extern "C"
