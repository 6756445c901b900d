"""Damage-aware extension likelihood (calcLikelihoodConsensus) and the
extension priority queue.

The per-candidate score is a log-likelihood of the overlap columns under
the position-dependent damage + sequencing-error model, with a penalty for
falling short of the longest candidate overlap, converted to a posterior
odds ratio against a random-alignment null (src/assembler/
nuclassembleUtil.cpp:203-374).

The column likelihood only depends on (damage layer, consensus base,
target base), so the whole computation reduces to a log-table lookup
`LOGM[l, qb, tb]` + masked segment sum — dense VPU work in the TPU path;
this module is the NumPy oracle.

`CppPriorityQueue` replicates libstdc++'s std::push_heap/__adjust_heap so
that pop order ties match the reference's std::priority_queue exactly.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

from ..constants import CHAR_TO_ACGT, SMOOTHING_VALUE
from ..damage import layer_index

_libm = ctypes.CDLL("libm.so.6")
_libm.logf.restype = ctypes.c_float
_libm.logf.argtypes = (ctypes.c_float,)


def logf32(x: float) -> np.float32:
    """glibc logf of float(x).  The reference's penalty terms resolve to the
    float overload of std::log (libgab.h:37 `using namespace std` + float
    parameters randAlnPenal/excessPenal, nuclassembleUtil.cpp:330-336), so
    `excess * log(excessPenal)` and `maxAln * log(randAlnPenal)` are f32
    products of f32 logs."""
    return np.float32(_libm.logf(ctypes.c_float(x)))


def sln_ratio_exact(lik_mod_ld, aln_count: int, max_aln: int,
                    rand_aln_penal: float, excess_penal: float):
    """The tail of calcLikelihoodConsensus (nuclassembleUtil.cpp:328-375)
    in the reference's exact mixed precision:

      likMod (long double) += float(excess) * logf(excessPenal)    [f32]
      randAln = double(float(maxAln) * logf(randAlnPenal))
      sLenNorm = double(likMod)
      sRatio   = double(1.0L / (1.0L + expl(randAln - likMod)))
    """
    excess = max_aln - aln_count
    term = np.float32(excess) * logf32(excess_penal)
    lik_ld = np.longdouble(lik_mod_ld) + np.longdouble(term)
    sln = float(np.float64(lik_ld))
    rand_aln = np.float64(np.float32(max_aln) * logf32(rand_aln_penal))
    ratio = float(ratio_ld_array(np.array([rand_aln]),
                                 np.array([lik_ld], dtype=np.longdouble))[0])
    return sln, ratio


def ratio_ld_array(rand_aln: np.ndarray, lik_ld: np.ndarray) -> np.ndarray:
    """Vector sRatio with exact expl semantics via the native helper
    (ctypes cannot pass/return long double without truncating through a
    Python double)."""
    from .. import native
    return native.lik_ratio_ld(rand_aln, lik_ld)


def likelihood_table(deam: np.ndarray, seq_err: np.ndarray) -> np.ndarray:
    """LOGM[l, qb, tb] = log( sum_z max(deam[l,qb,z], S) * seqErr[z, tb] ).

    Bit-exact to the reference's per-column computation (nuclassembleUtil.
    cpp:148-162): match_lik = double(max(ld SMOOTHING, ld p[qb][z]));
    lik is a DOUBLE accumulated with per-step long-double products
    (`lik += tBaseErr * match_lik` with ld tBaseErr); the final log is
    glibc's double log.  Pass the long-double tensors (DamageModel.fwd_ld,
    seq_error_profile_ld); f64 inputs are widened exactly."""
    deam = np.asarray(deam, dtype=np.longdouble)
    seq_err = np.asarray(seq_err, dtype=np.longdouble)
    S = np.longdouble(np.float64(SMOOTHING_VALUE))
    match = np.maximum(deam, S).astype(np.float64)      # (L, 4q, 4z) double
    lik = np.zeros(deam.shape[:-1] + (4,), dtype=np.float64)
    for z in range(4):
        prod = seq_err[z, :] * match[..., z][..., None].astype(np.longdouble)
        lik = (lik.astype(np.longdouble) + prod).astype(np.float64)
    out = np.empty_like(lik)
    flat_in = lik.reshape(-1)
    flat_out = out.reshape(-1)
    for i in range(flat_in.size):
        flat_out[i] = math.log(flat_in[i])
    return out


def calc_likelihood_consensus(logm: np.ndarray, consensus: np.ndarray,
                              query_len: int, target: np.ndarray,
                              qstart: int, qend: int, tstart: int, tend: int,
                              aln_len: int, max_aln: int,
                              rand_aln_penal: float, excess_penal: float):
    """Returns (sLenNorm, sRatio) for one candidate (nuclassembleUtil.cpp:
    203-374).  `consensus` is the 3*query_len byte array, `target` the full
    (possibly revcomp'd) target byte array; coords are the alignment's.

    Only leftStart (qstart==0 && tend==tlen-1) / rightStart (tstart==0 &&
    qend==query_len-1) candidates accumulate columns; anything else scores
    the pure excess penalty.
    """
    tlen = len(target)
    right_start = tstart == 0 and qend == query_len - 1
    left_start = qstart == 0 and tend == tlen - 1

    lik_mod = 0.0
    aln_count = 0
    offset = tlen - aln_len
    consensus_start = query_len - offset
    if (left_start or right_start) and consensus_start >= 0:
        target = np.asarray(target, dtype=np.uint8)
        # tIdx counts chars != 'N' (literally 'N', the pad letter);
        # columns need BOTH consensus and target chars != 'N' (:255-266)
        t_not_n = target != ord("N")
        t_rank = np.cumsum(t_not_n) - 1
        layers = layer_index(t_rank, tlen)

        if left_start:
            # padded target occupies consensus positions
            # [consensus_start, consensus_start + tlen)
            cons_pos = consensus_start + np.arange(tlen)
        else:
            # right pad: padded length = tlen + consensus_start, and
            # consIdx = 3*query_len - padded_len + i  for i in [0, padded)
            cons_pos = 3 * query_len - (tlen + consensus_start) + np.arange(tlen)
        in_range = (cons_pos >= 0) & (cons_pos < 3 * query_len)
        cons_chars = np.zeros(tlen, dtype=np.uint8)
        cons_chars[in_range] = consensus[cons_pos[in_range]]
        use = t_not_n & (cons_chars != ord("N")) & in_range
        if use.any():
            qb = CHAR_TO_ACGT[cons_chars[use]].astype(np.int64)
            tb = CHAR_TO_ACGT[target[use]].astype(np.int64)
            ls = layers[use]
            # sequential 80-bit accumulation (the reference's
            # `long double likMod += log(lik)` loop; cumsum is sequential,
            # np.sum's pairwise grouping is not)
            lik_mod = logm[ls, qb, tb].astype(np.longdouble).cumsum()[-1]
            aln_count = int(use.sum())

    return sln_ratio_exact(lik_mod, aln_count, max_aln,
                           rand_aln_penal, excess_penal)


class CppPriorityQueue:
    """std::priority_queue with libstdc++'s exact heap algorithms, so pop
    order (including comparator ties) matches the reference binary."""

    def __init__(self, comp_less):
        self._v = []
        self._less = comp_less  # comp(a, b) == "a < b"

    def __len__(self):
        return len(self._v)

    def push(self, value):
        v = self._v
        v.append(value)
        # __push_heap: sift the new value up
        hole = len(v) - 1
        while hole > 0:
            parent = (hole - 1) // 2
            if self._less(v[parent], value):
                v[hole] = v[parent]
                hole = parent
            else:
                break
        v[hole] = value

    def pop(self):
        """pop_heap + pop_back; returns the former top."""
        v = self._v
        top = v[0]
        value = v.pop()
        n = len(v)
        if n == 0:
            return top
        # __adjust_heap(first, holeIndex=0, len=n, value)
        hole = 0
        second = 0
        while second < (n - 1) // 2:
            second = 2 * (second + 1)
            if self._less(v[second], v[second - 1]):
                second -= 1
            v[hole] = v[second]
            hole = second
        if n % 2 == 0 and second == (n - 2) // 2:
            second = 2 * (second + 1)
            v[hole] = v[second - 1]
            hole = second - 1
        # __push_heap(first, hole, 0, value)
        while hole > 0:
            parent = (hole - 1) // 2
            if self._less(v[parent], value):
                v[hole] = v[parent]
                hole = parent
            else:
                break
        v[hole] = value
        return top

    def empty(self):
        return not self._v
