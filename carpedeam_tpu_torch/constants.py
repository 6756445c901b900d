"""Alphabet, scoring-matrix and statistical constants.

Numeric conventions follow the reference implementation exactly so that
contigs are bit-compatible (reference: lib/mmseqs/data/nucleotide.out,
lib/mmseqs/src/commons/NucleotideMatrix.cpp:9-63,
lib/mmseqs/src/prefiltering/Indexer.h:136-151).
"""
import numpy as np

# ---------------------------------------------------------------------------
# Alphabet.  The reference 2-bit code order is A=0, C=1, T=2, G=3 (the row
# order of nucleotide.out; see Indexer::printKmer nuclCode = {A,C,T,G}).
# X (= every non-ACGT IUPAC letter after folding) is 4.
# NOTE: this is *not* the usual A,C,G,T order.
# ---------------------------------------------------------------------------
A, C, T, G, X = 0, 1, 2, 3, 4
ALPHABET = "ACTGX"
ALPHABET_SIZE = 5

# complement in 2-bit code space: A<->T is 0<->2, C<->G is 1<->3  ==  code ^ 2
COMPLEMENT_CODE = np.array([2, 3, 0, 1, 4], dtype=np.uint8)

# char -> 2-bit/5-letter code, replicating NucleotideMatrix::setupLetterMapping
# (lib/mmseqs/src/commons/NucleotideMatrix.cpp:17-62): IUPAC ambiguity codes
# fold to T/G/C; everything else folds to X.
CHAR_TO_CODE = np.full(256, X, dtype=np.uint8)
for _ch, _code in (("Aa", A), ("Cc", C), ("TtUuWw", T), ("Gg", G)):
    for _c in _ch:
        CHAR_TO_CODE[ord(_c)] = _code
for _c in "KkBbDdVvRrSs":
    CHAR_TO_CODE[ord(_c)] = G
for _c in "MmYyHh":
    CHAR_TO_CODE[ord(_c)] = C

# char -> RY (purine/pyrimidine) class used for rySeqId.  The reference maps
# via std::unordered_map {'A':0,'C':1,'G':0,'T':1} (src/assembler/
# nuclassembleUtil.cpp:578-582); any other char (e.g. 'N') default-constructs
# to 0 in an unordered_map lookup, replicated here with 0.
CHAR_TO_RY = np.zeros(256, dtype=np.uint8)
CHAR_TO_RY[ord("C")] = 1
CHAR_TO_RY[ord("T")] = 1

# char -> nucleotideMap index used by the damage / correction math.  The
# reference maps {'A':0,'C':1,'G':2,'T':3} and *any other char* (N, ...)
# default-inserts as 0 == 'A' (std::unordered_map operator[] semantics).
CHAR_TO_ACGT = np.zeros(256, dtype=np.uint8)
CHAR_TO_ACGT[ord("A")] = 0
CHAR_TO_ACGT[ord("C")] = 1
CHAR_TO_ACGT[ord("G")] = 2
CHAR_TO_ACGT[ord("T")] = 3
ACGT = "ACGT"

# char-level reverse complement used on raw sequence bytes, replicating
# getNuclRevFragment (src/assembler/nuclassembleUtil.cpp:67-76): fold char to
# 5-letter code, complement, decode, X -> 'N'.
_DECODE = np.frombuffer(b"ACTGN", dtype=np.uint8)
CHAR_REVCOMP = _DECODE[COMPLEMENT_CODE[CHAR_TO_CODE]]

# ---------------------------------------------------------------------------
# Substitution scores (nucleotide.out): +2 match / -3 mismatch, X scores -3
# against everything including itself.
# ---------------------------------------------------------------------------
MATCH_SCORE = 2
MISMATCH_SCORE = -3
SUB_MATRIX = np.full((5, 5), MISMATCH_SCORE, dtype=np.int32)
for _i in range(4):
    SUB_MATRIX[_i, _i] = MATCH_SCORE

# ascii x ascii score used by the rescorer: fold both chars through
# CHAR_TO_CODE (case-insensitive via the mapping itself) then SUB_MATRIX.
CHAR_SCORE = SUB_MATRIX[CHAR_TO_CODE[:, None], CHAR_TO_CODE[None, :]]

# ---------------------------------------------------------------------------
# Gumbel parameters of the ungapped +2/-3 nucleotide matrix.
#
# The reference computes these at startup with the ALP library
# (AlignmentEvaluer::initGapless over nucleotide.out's background
# frequencies 4 x 0.2499975 + 0.00001 X; lib/mmseqs/src/alignment/
# EvalueComputation.h:119-175).  The values below were extracted from the
# reference binary, built with a probe linking the same
# ALP code (see tools/extract_gumbel.cpp); they are deterministic
# (closed-form Karlin computation, no simulation for the gapless case).
# ---------------------------------------------------------------------------
GUMBEL = {
    "lambda": 0.63373155264486880078,
    "K": 0.40796623464181452912,
    "a": 0.69454686319701297581,      # a_I == a_J (b_* == 0)
    "alpha": 0.83333515157614945768,  # alpha_I == alpha_J == sigma (beta/tau 0)
}

SMOOTHING_VALUE = 1e-3  # src/assembler/nuclassembleUtil.cpp:2
