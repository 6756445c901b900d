// Native host runtime: per-sequence k-mer selection walk.
//
// The subsampling walk of kmermatcher (histogram threshold + duplicate-run
// skipping; reference lib/mmseqs/src/linclust/kmermatcher.cpp:226-350) is an
// inherently sequential per-sequence loop -- the wrong shape for the TPU but
// also too slow in Python for production inputs.  This C++ implementation
// processes the whole batch (all sequences, CSR layout) in one call and is
// exposed through ctypes (no pybind11 dependency).
//
// Arrays are the per-sequence (hash,kmer|b63,pos)-sorted k-mer entries, the
// per-sequence entry offsets, and per-sequence kmerConsidered budgets.  The
// output is a 0/1 selection mask over entries.
#include <cstdint>
#include <cstring>

extern "C" {

void select_kmers_batch(
    const uint64_t *masked_kmers,  // kmer | bit63, sorted within sequence
    const uint16_t *hashes,        // 16-bit subsampling hash, sorted key
    const int64_t *seq_offsets,    // (n_seqs + 1,) entry ranges
    const int64_t *kmer_considered,// (n_seqs,)
    int64_t n_seqs,
    uint8_t *selected)             // out: (total_entries,) 0/1
{
    for (int64_t s = 0; s < n_seqs; s++) {
        const int64_t begin = seq_offsets[s];
        const int64_t end = seq_offsets[s + 1];
        const int64_t n = end - begin;
        if (n <= 0) continue;
        const uint64_t *mk = masked_kmers + begin;
        const uint16_t *hs = hashes + begin;
        uint8_t *sel = selected + begin;
        const int64_t considered = kmer_considered[s];

        // histogram threshold (65536 bins via the 128-bin hierarchy)
        // (kmermatcher.cpp:226-241)
        static thread_local int32_t score_dist[65536];
        static thread_local int32_t hier[128];
        memset(score_dist, 0, sizeof(score_dist));
        memset(hier, 0, sizeof(hier));
        for (int64_t i = 0; i < n; i++) {
            score_dist[hs[i]]++;
            hier[hs[i] >> 9]++;
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

        // the selection walk with duplicate-run skipping (:276-350)
        int64_t sel_count = 0;
        for (int64_t i = 0; i < n && sel_count < considered; i++) {
            if (i + 1 < n && mk[i] == mk[i + 1]) {
                const uint64_t cur = mk[i];
                while (i < n && mk[i] == cur) i++;
                if (i >= n) break;
            }
            if ((int64_t)hs[i] < threshold) {
                if ((int64_t)hs[i] == threshold - 1 && too_much) {
                    too_much--;
                    if (too_much == 0) threshold--;
                }
                sel_count++;
                sel[i] = 1;
            }
        }
    }
}

}  // extern "C"
