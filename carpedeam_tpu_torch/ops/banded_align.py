"""Banded affine-gap nucleotide alignment (the ksw2 / BandedNucleotide-
Aligner role in linclust's `align` stage).

The reference aligns candidate pairs with ksw_extz2_sse (band 64, +2/-3
nucleotide matrix, affine gaps o=5 e=2) anchored at the prefilter
diagonal (lib/mmseqs/src/alignment/BandedNucleotideAligner.cpp:169-195);
the result's identity/coverage feed the 0.97/0.99 cluster filter.  This
module fills the same role with a banded Gotoh DP (native/banded.cpp):

  * the overlap window is anchored at the prefilter diagonal exactly
    like the ungapped scorer (one side starts at 0);
  * a banded (±64 around the anchor diagonal) affine-gap DP runs the
    window semi-globally: the alignment starts at the window start and
    ends at the end of either sequence (end-to-end overlap with
    internal indels);
  * identities / alignment length come from the traceback (gap
    placement within a run follows the H-source convention).

For indel-free pairs the optimal band path is the plain diagonal, so
scores, identities and filter decisions reduce to the ungapped
scorer's; pairs with small indels — where the ungapped filter
under-counts identity — survive like the reference's gapped filter.
"""
from __future__ import annotations

import numpy as np


def banded_align(q: np.ndarray, t: np.ndarray, band: int = 64,
                 match: int = 2, mismatch: int = -3, gapo: int = 5,
                 gape: int = 2):
    """Banded affine-gap semi-global alignment of code arrays q vs t
    (already windowed so both start at alignment start).

    Returns (score, q_end, t_end, n_ident, aln_len): the alignment spans
    q[0:q_end+1] / t[0:t_end+1] and ends at the end of q or of t.
    """
    nq, nt = len(q), len(t)
    if nq == 0 or nt == 0:
        return 0, -1, -1, 0, 0
    from .. import native
    return native.banded_align_one(q, t, band, match, mismatch, gapo, gape)
