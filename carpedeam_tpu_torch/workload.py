"""Synthetic ancient-DNA workload, made in memory from a seed.

The port's twin of tools/make_workload.generate: reads sampled uniformly
from a random genome at a target coverage (lengths 35-120, mean 51, an
exponential tail as in the reference's example data), reverse-complemented
on random strands, deaminated with position-dependent C->T (5' end) and
G->A (3' end) rates, plus uniform sequencing error.  With `species` > 1
the reads come from a mock community of that many random genomes with
log-skewed abundances, as the tool's `--species` draws them.  The reads
come back as a SeqDB in createdb's shuffled record order (32 round-robin
splits, SeqDB.from_fastx), with the damage profile rates that made them.
"""
from __future__ import annotations

import numpy as np

from .io.seqdb import SeqDB

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("T", "A"), ("C", "G"), ("G", "C")):
    _COMP[ord(_a)] = ord(_b)

# per-position damage rates, position 0 = the read's terminal base; rows
# past the list use the last value (the interior rate)
CT5 = (0.35, 0.22, 0.15, 0.11, 0.08, 0.06, 0.04, 0.03, 0.02, 0.01)
GA3 = (0.33, 0.21, 0.14, 0.10, 0.08, 0.06, 0.04, 0.03, 0.02, 0.01)
# column order of a profile row: A>C A>G A>T C>A C>G C>T G>A G>C G>T
# T>A T>C T>G; every other substitution gets this background rate
BACKGROUND = 0.0005


def profile_rates(ct5=CT5, ga3=GA3, background=BACKGROUND):
    """(sub5p, sub3p) rate tables, (rows, 12) float64 each, in the layout
    DamageModel.from_rates reads (C>T is column 5, G>A column 6)."""
    def table(col, rates):
        t = np.full((len(rates), 12), background, dtype=np.float64)
        t[:, col] = rates
        return t
    return table(5, ct5), table(6, ga3)


def generate(seed: int, n_reads: int, coverage: float = 20.0,
             min_len: int = 35, max_len: int = 120, mean_len: float = 51.0,
             seq_err: float = 0.001, ct5=CT5, ga3=GA3, species: int = 1):
    """Returns (reads SeqDB, (sub5p, sub3p) profile rates).

    `species` > 1 draws a mock ancient community (BASELINE.json configs
    3 and 4): independent random genomes with abundance weights
    w_i ~ 2^(-i/2), each read assigned to a species by `rng.choice`, each
    genome sized so that its own reads reach `coverage`; the draws come
    in tools/make_workload.py's order, so a seed gives the tool's reads."""
    rng = np.random.default_rng(seed)
    ct5 = np.asarray(ct5, dtype=np.float64)
    ga3 = np.asarray(ga3, dtype=np.float64)
    lengths = np.minimum(
        min_len + rng.exponential(mean_len - min_len, n_reads),
        max_len).astype(np.int64)
    total = int(lengths.sum())
    if species <= 1:
        genome_len = max(int(total / coverage), max_len + 1)
        genome = BASES[rng.integers(0, 4, genome_len)]
        starts = rng.integers(0, genome_len - lengths + 1)
    else:
        w = 2.0 ** (-0.5 * np.arange(species))
        w /= w.sum()
        sp_of = rng.choice(species, size=n_reads, p=w)
        res_per = np.bincount(sp_of, weights=lengths,
                              minlength=species).astype(np.int64)
        glens = np.maximum((res_per / coverage).astype(np.int64),
                           max_len + 1)
        goff = np.concatenate([[0], np.cumsum(glens)])
        genome = BASES[rng.integers(0, 4, int(goff[-1]))]
        starts = goff[sp_of] + rng.integers(0, glens[sp_of] - lengths + 1)
    minus = rng.integers(0, 2, n_reads).astype(bool)

    offsets = np.concatenate([[0], np.cumsum(lengths)])[:-1]
    pos5 = np.arange(total) - np.repeat(offsets, lengths)
    pos3 = np.repeat(lengths, lengths) - 1 - pos5
    reads = genome[np.repeat(starts, lengths) + pos5]
    # minus-strand reads: reverse complement within each read
    flip = np.repeat(minus, lengths)
    src = np.where(flip, np.repeat(offsets, lengths) + pos3,
                   np.arange(total))
    reads = np.where(flip, _COMP[reads[src]], reads[src]).astype(np.uint8)

    p_ct = ct5[np.minimum(pos5, len(ct5) - 1)]
    p_ga = ga3[np.minimum(pos3, len(ga3) - 1)]
    u = rng.random(total)
    reads = np.where((reads == ord("C")) & (u < p_ct), ord("T"), reads)
    reads = np.where((reads == ord("G")) & (u < p_ga), ord("A"), reads) \
        .astype(np.uint8)
    err = rng.random(total) < seq_err
    if err.any():
        shift = rng.integers(1, 4, int(err.sum()))
        reads[err] = BASES[(np.searchsorted(BASES, reads[err]) + shift) % 4]

    # createdb's shuffled record order (SeqDB.from_fastx, shuffle=True)
    perm = np.concatenate([np.arange(s, n_reads, 32) for s in range(32)])
    lp = lengths[perm]
    within = np.arange(total) - np.repeat(np.cumsum(lp) - lp, lp)
    db = SeqDB.from_flat(reads[np.repeat(offsets[perm], lp) + within], lp)
    return db, profile_rates(ct5, ga3)
