"""consensusCaller: the extension consensus buffer (safe + unsafe modes).

Re-design of nuclassembleUtil.cpp:570-702.  The consensus is a 3L byte
buffer ('N'-filled) whose middle third is the (trusted, corrected) query.
In safe mode (default) that is all.  In unsafe mode (--unsafe), candidate
extension overlaps first vote base counts into the buffer: a majority call
with minimum coverage (--min-cov-safe) and tie -> 'N' fills the flanks
(calculateConsensus, :535-567), and the query then overrides the middle
third regardless.
"""
from __future__ import annotations

import numpy as np

from ..constants import CHAR_TO_ACGT

_ACGT_BYTES = np.frombuffer(b"ACGT", dtype=np.uint8)


def consensus_caller(cands, tgt_of, query: np.ndarray, qlen: int,
                     unsafe: bool, min_cov: int) -> np.ndarray:
    """Build the 3L consensus buffer.

    `cands` are candidate records with canonicalised coords (qstart, qend,
    tstart, tend, tlen, aln_len, tkey); `tgt_of(c)` returns the candidate's
    strand-corrected target bytes.  The query-key identity filter has
    already removed self-hits from `cands`.
    """
    consensus = np.full(3 * qlen, ord("N"), dtype=np.uint8)
    if not unsafe:
        consensus[qlen:2 * qlen] = query
        return consensus

    cov = np.zeros((3 * qlen, 4), dtype=np.int64)
    for c in cands:
        # outer guard (:611-613): overlap must not be contained
        right_start = c.tstart == 0 and c.tend != c.tlen - 1
        left_start = c.qstart == 0 and c.qend != c.qlen - 1
        if not (right_start or left_start):
            continue
        seq = tgt_of(c)
        tb = CHAR_TO_ACGT[seq[:c.tlen]].astype(np.int64)
        if c.tstart == 0 and c.qend == qlen - 1:
            # right extension (:646-652): target base `pos` votes at
            # consensus position qlen + qstart + pos
            vec = qlen + c.qstart + np.arange(c.tlen)
        elif c.qstart == 0 and c.tend == c.tlen - 1:
            # left extension (:654-660)
            vec = qlen - (c.tlen - c.aln_len) + np.arange(c.tlen)
        else:
            continue
        ok = (vec >= 0) & (vec < 3 * qlen)
        np.add.at(cov, (vec[ok], tb[ok]), 1)

    tot = cov.sum(axis=1)
    mx = cov.max(axis=1)
    arg = cov.argmax(axis=1)
    n_max = (cov == mx[:, None]).sum(axis=1)
    call = np.where((n_max == 1) & (mx > 0), _ACGT_BYTES[arg], ord("N"))
    consensus = np.where(tot >= min_cov, call, ord("N")).astype(np.uint8)
    consensus[qlen:2 * qlen] = query
    return consensus
