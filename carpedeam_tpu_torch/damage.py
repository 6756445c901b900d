"""Damage model: position-dependent deamination substitution tensors.

Replicates initDeamProbabilities / getSeqErrorProf of the reference
(src/assembler/nuclassembleUtil.cpp:821-1007, :49-65) including its quirks:

* A profile is a 12-column TSV (A>C A>G A>T C>A C>G C>T G>A G>C G>T T>A T>C
  T>G) with one row per position; the first five 5' rows and the last five
  3' rows are used.
* The interior ("default") matrix takes its C->T rate from the LAST 5' row
  and its G->A rate from the FIRST 3' row.
* Every 5'-row matrix has its G->A / G->G entries overwritten with the
  interior G->A rate, and every 3'-row matrix its C->T / C->C entries with
  the interior C->T rate.
* The result is an (11, 4, 4) tensor `p[l, from, to]` with layers
  l = 0..4 (5' positions 0..4), l = 5 (interior), l = 6..10 (3' file rows
  in file order, applied to target positions L-5..L-1).
* The reverse-strand tensor swaps C->T and G->A between mirrored layers.

Base order in the 4x4 matrices is A, C, G, T (the reference's
nucleotideMap), *not* the 2-bit code order of constants.py.
"""
from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

N_LAYERS = 11  # 5 five-prime + 1 interior + 5 three-prime

# (from, to) index pairs for the 12 off-diagonal columns, row-major with
# diagonal skipped: A>C A>G A>T C>A C>G C>T G>A G>C G>T T>A T>C T>G
_OFFDIAG = [(i, j) for i in range(4) for j in range(4) if i != j]


def _read_rate_fields(path: str) -> list[list[str]]:
    """Raw string fields of a damage profile TSV (possibly gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        header = fh.readline()
        if len(header.rstrip("\n").split("\t")) != 12:
            raise ValueError(f"Profile {path}: header does not have 12 fields")
        rows = []
        for line in fh:
            if not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) != 12:
                raise ValueError(f"Profile {path}: row does not have 12 fields")
            rows.append(fields)
    return rows


def read_substitution_rates(path: str) -> np.ndarray:
    """Parse a damage profile TSV (possibly gzipped) into an (R, 12) array.

    Replicates readNucSubstitionRatesFreq (src/assembler/
    nuclassembleUtil.h:53-102): a 12-field header line then R data rows.
    """
    rows = _read_rate_fields(path)
    return np.array([[float(x) for x in r] for r in rows], dtype=np.float64)


def read_substitution_rates_ld(path: str) -> np.ndarray:
    """Same rows parsed straight to 80-bit long double (the reference's
    destringify<long double>, nuclassembleUtil.h:89 — text->ld differs from
    text->f64->ld in the last ulps, which matters for exact-tie queue
    ordering)."""
    rows = _read_rate_fields(path)
    out = np.empty((len(rows), 12), dtype=np.longdouble)
    for i, r in enumerate(rows):
        for k, x in enumerate(r):
            out[i, k] = np.longdouble(x)
    return out


def _rates_to_matrix(rates_row: np.ndarray) -> np.ndarray:
    """One 12-vector of off-diagonal rates -> 4x4 matrix, diagonal = 1-sum(row)."""
    m = np.zeros((4, 4), dtype=np.float64)
    for k, (i, j) in enumerate(_OFFDIAG):
        m[i, j] = rates_row[k]
    for i in range(4):
        m[i, i] = 1.0 - (m[i].sum() - m[i, i])
    return m


@dataclass
class DamageModel:
    """Forward and reverse deamination tensors plus raw profile rows.

    `fwd`/`rev` are the f64 tensors used by correction and all f64 paths;
    `fwd_ld`/`rev_ld` replicate the reference's 80-bit `long double
    diNucleotideProb` construction bit-for-bit (including the points where
    it rounds through double) for the extension-likelihood table."""

    fwd: np.ndarray  # (11, 4, 4) p[layer, qBase(ACGT), tBase(ACGT)]
    rev: np.ndarray  # (11, 4, 4) strand-swapped version
    sub5p: np.ndarray  # raw (R5, 12)
    sub3p: np.ndarray  # raw (R3, 12)
    fwd_ld: np.ndarray = None  # (11, 4, 4) np.longdouble
    rev_ld: np.ndarray = None

    @staticmethod
    def zero() -> "DamageModel":
        """No-damage model (identity matrices); used when no --ancient-damage
        prefix is given (reference: initDeamProbabilities's '5p.prof' branch,
        nuclassembleUtil.cpp:824-832)."""
        z = np.zeros((5, 12), dtype=np.float64)
        return DamageModel.from_rates(z, z)

    @staticmethod
    def load(damage_path_prefix: str) -> "DamageModel":
        """Load `<prefix>5p.prof` / `<prefix>3p.prof` (the reference appends
        these suffixes to --ancient-damage; src/assembler/correction.cpp:155)."""
        if damage_path_prefix in ("", None):
            return DamageModel.zero()
        p5 = damage_path_prefix + "5p.prof"
        p3 = damage_path_prefix + "3p.prof"
        if not (os.path.exists(p5) or os.path.exists(p5 + ".gz")):
            raise FileNotFoundError(p5)
        if os.path.exists(p5 + ".gz") and not os.path.exists(p5):
            p5 += ".gz"
        if os.path.exists(p3 + ".gz") and not os.path.exists(p3):
            p3 += ".gz"
        return DamageModel.from_rates(read_substitution_rates(p5),
                                      read_substitution_rates(p3),
                                      read_substitution_rates_ld(p5),
                                      read_substitution_rates_ld(p3))

    @staticmethod
    def from_rates(sub5p: np.ndarray, sub3p: np.ndarray,
                   sub5p_ld: np.ndarray = None,
                   sub3p_ld: np.ndarray = None) -> "DamageModel":
        # interior matrix: identity, then C->T from last 5' row (col 5) and
        # G->A from first 3' row (col 6)
        default = np.eye(4, dtype=np.float64)
        if len(sub5p):
            ct = sub5p[-1, 5]
            default[1, 3] = ct          # C->T
            default[1, 1] = 1.0 - ct    # C->C
        if len(sub3p):
            ga = sub3p[0, 6]
            default[2, 0] = ga          # G->A
            default[2, 2] = 1.0 - ga    # G->G
        layers = []
        for row in sub5p[:5]:
            m = _rates_to_matrix(row)
            m[2, 0] = default[2, 0]     # overlay interior G->A
            m[2, 2] = default[2, 2]
            layers.append(m)
        three_prime = []
        for row in sub3p[-5:]:
            m = _rates_to_matrix(row)
            m[1, 3] = default[1, 3]     # overlay interior C->T
            m[1, 1] = default[1, 1]
            three_prime.append(m)
        fwd = np.stack(layers + [default] + three_prime)  # (11,4,4)

        # reverse-strand tensor: layer i takes its C->T/C->C from layer
        # (10-i)'s G->A/G->G and vice versa (nuclassembleUtil.cpp:966-981)
        rev = fwd.copy()
        end = fwd[::-1]
        rev[:, 1, 3] = end[:, 2, 0]
        rev[:, 1, 1] = end[:, 2, 2]
        rev[:, 2, 0] = end[:, 1, 3]
        rev[:, 2, 2] = end[:, 1, 1]
        if sub5p_ld is None:
            sub5p_ld = sub5p.astype(np.longdouble)
        if sub3p_ld is None:
            sub3p_ld = sub3p.astype(np.longdouble)
        fwd_ld, rev_ld = _tensors_ld(sub5p_ld, sub3p_ld)
        return DamageModel(fwd=fwd, rev=rev, sub5p=sub5p, sub3p=sub3p,
                           fwd_ld=fwd_ld, rev_ld=rev_ld)


def _tensors_ld(sub5p: np.ndarray, sub3p: np.ndarray):
    """80-bit replica of initDeamProbabilities (nuclassembleUtil.cpp:
    821-1007) with the reference's exact rounding points:

    * profile values are long double (destringify<long double>);
    * the interior matrix's C->C / G->G are full-ld `1 - rate`;
    * the overlay values applied to end rows round through DOUBLE first
      (the `unordered_map<int, double> defaultCT/GA`, :878-882);
    * each row's diagonal is `1.0 - sum` where `sum` is a DOUBLE that
      accumulated the three ld off-diagonals with per-step rounding
      (`double sum; sum += origStruct.s[k]`, :894-906).
    """
    one = np.longdouble(1.0)
    default = np.zeros((4, 4), dtype=np.longdouble)
    np.fill_diagonal(default, one)
    if len(sub5p):
        ct = sub5p[-1, 5]
        default[1, 3] = ct
        default[1, 1] = one - ct
    if len(sub3p):
        ga = sub3p[0, 6]
        default[2, 0] = ga
        default[2, 2] = one - ga
    dct_13 = np.longdouble(np.float64(default[1, 3]))
    dct_11 = np.longdouble(np.float64(default[1, 1]))
    dga_20 = np.longdouble(np.float64(default[2, 0]))
    dga_22 = np.longdouble(np.float64(default[2, 2]))

    def row_matrix(row: np.ndarray) -> np.ndarray:
        m = np.zeros((4, 4), dtype=np.longdouble)
        k = 0
        for i in range(4):
            s = np.float64(0.0)
            for j in range(4):
                if i == j:
                    continue
                m[i, j] = row[k]
                s = np.float64(np.longdouble(s) + row[k])
                k += 1
            m[i, i] = np.longdouble(np.float64(1.0) - s)
        return m

    layers5 = []
    for row in sub5p[:5]:
        m = row_matrix(row)
        m[2, 0] = dga_20
        m[2, 2] = dga_22
        layers5.append(m)
    layers3 = []
    for row in sub3p[-5:]:
        m = row_matrix(row)
        m[1, 3] = dct_13
        m[1, 1] = dct_11
        layers3.append(m)
    fwd = np.stack(layers5 + [default] + layers3)
    rev = fwd.copy()
    end = fwd[::-1]
    rev[:, 1, 3] = end[:, 2, 0]
    rev[:, 1, 1] = end[:, 2, 2]
    rev[:, 2, 0] = end[:, 1, 3]
    rev[:, 2, 2] = end[:, 1, 1]
    return fwd, rev


def seq_error_profile(err: float) -> np.ndarray:
    """4x4 sequencing-error matrix: 1-err on the diagonal, err/3 elsewhere
    (getSeqErrorProf, nuclassembleUtil.cpp:49-65)."""
    m = np.full((4, 4), err / 3.0, dtype=np.float64)
    np.fill_diagonal(m, 1.0 - err)
    return m


def seq_error_profile_ld(err: float) -> np.ndarray:
    """getSeqErrorProf in the reference's 80-bit arithmetic: err is a
    double literal widened to long double (`long double seqErrCorrection =
    0.001`, ancientReadsResults.cpp:172); 1-err and err/3 computed in ld."""
    e = np.longdouble(np.float64(err))
    m = np.full((4, 4), e / np.longdouble(3), dtype=np.longdouble)
    np.fill_diagonal(m, np.longdouble(1.0) - e)
    return m


def layer_index(positions: np.ndarray, length) -> np.ndarray:
    """Damage-layer index for 0-based positions in a sequence of `length`:
    0..4 for the first five, 5 interior, 6..10 for the last five
    (the subdeam_lookup construction, nuclassembleUtil.cpp:130-140).

    For length < 10 the reference's construction overlaps the two end
    ranges with the 3' write happening last; replicated here.
    """
    positions = np.asarray(positions)
    idx = np.full(positions.shape, 5, dtype=np.int32)
    idx = np.where(positions < 5, positions.astype(np.int32), idx)
    from_end = positions - (length - 5)
    idx = np.where(from_end >= 0, 6 + from_end.astype(np.int32), idx)
    return idx
