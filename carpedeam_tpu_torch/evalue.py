"""Karlin-Altschul / ALP-compatible e-value statistics.

Replicates EvalueComputation (lib/mmseqs/src/alignment/EvalueComputation.h)
for the ungapped +2/-3 nucleotide matrix.  The Gumbel parameters are the
exact values AlignmentEvaluer::initGapless produces for that matrix with
background frequencies 4 x 0.2499975 (extracted with tools/extract_gumbel
against the vendored ALP sources); the finite-size-correction "area" is
the closed form of pvalues::get_appr_tail_prob_with_cov_without_errors
(lib/mmseqs/lib/alp/sls_pvalues.cpp:366-540) for the gapless case
(b = beta = tau = 0, a_I = a_J = a, alpha_I = alpha_J = sigma = alpha).

All functions are NumPy-vectorised over scores.
"""
from __future__ import annotations

import math

import numpy as np

LAMBDA = 0.63373155264486880078
K = 0.40796623464181452912
LOG_K = math.log(K)
A_FSC = 0.69454686319701297581      # par.a_I == par.a_J
ALPHA_FSC = 0.83333515157614945768  # par.alpha_* == par.sigma
# vi_y_thr = vj_y_thr = c_y_thr = 2*alpha/lambda (nat_cut_off_in_max = 2,
# sls_pvalues.cpp:46,352-354)
_Y_THR = 2.0 * ALPHA_FSC / LAMBDA
LN2 = math.log(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _phi(x):
    """Standard normal CDF: 0.5*erfc(-x/sqrt(2)) (sls_basic.hpp:195-198)."""
    from math import erfc
    x = np.asarray(x, dtype=np.float64)
    return 0.5 * np.vectorize(erfc)(-math.sqrt(0.5) * x)


def bit_score(raw_score):
    """(lambda*S - ln K)/ln 2 (sls_alignment_evaluer.hpp:159-162)."""
    return (LAMBDA * np.asarray(raw_score, dtype=np.float64) - LOG_K) / LN2


def bit_score_int(raw_score):
    """The int(bitScore + 0.5) stored in alignment records
    (rescorediagonal.cpp:252)."""
    return (bit_score(raw_score) + 0.5).astype(np.int32)


def raw_score_from_bit_score(bit):
    """(logK + bit*ln2)/lambda (EvalueComputation.h:22-24)."""
    return (LOG_K + np.asarray(bit, dtype=np.float64) * LN2) / LAMBDA


def area(score, seq_len, db_res_count):
    """Finite-size-corrected search-space area (sls_pvalues.cpp:423-524)."""
    y = np.asarray(score, dtype=np.float64)
    m = np.asarray(seq_len, dtype=np.float64)
    n = float(db_res_count)

    m_li_y = m - A_FSC * y
    vi_y = np.maximum(_Y_THR, ALPHA_FSC * y)
    sqrt_vi = np.sqrt(vi_y)
    m_f = np.where(sqrt_vi == 0.0, 1e100, m_li_y / np.where(sqrt_vi == 0, 1, sqrt_vi))
    p_m = _phi(m_f)
    e_m = -_INV_SQRT_2PI * np.exp(-0.5 * m_f * m_f)
    p1 = m_li_y * p_m - sqrt_vi * e_m

    n_lj_y = n - A_FSC * y
    vj_y = np.maximum(_Y_THR, ALPHA_FSC * y)
    sqrt_vj = np.sqrt(vj_y)
    n_f = np.where(sqrt_vj == 0.0, 1e100, n_lj_y / np.where(sqrt_vj == 0, 1, sqrt_vj))
    p_n = _phi(n_f)
    e_n = -_INV_SQRT_2PI * np.exp(-0.5 * n_f * n_f)
    p2 = n_lj_y * p_n - sqrt_vj * e_n

    c_y = np.maximum(_Y_THR, ALPHA_FSC * y)
    return p1 * p2 + c_y * p_m * p_n


def evalue(score, seq_len, db_res_count):
    """K*exp(-lambda*S) * area  (EvalueComputation::computeEvalue)."""
    y = np.asarray(score, dtype=np.float64)
    return K * np.exp(-LAMBDA * y) * area(y, seq_len, db_res_count)


def evalue_grouped(score, seq_len, db_res_count):
    """evalue() computed once per distinct (score, seq_len) pair and
    scattered back — bit-identical (same math.erfc path), but the
    dominant cost (the scalar erfc under np.vectorize) runs on the few
    thousand unique pairs instead of every alignment record."""
    s = np.asarray(score, dtype=np.int64)
    m = np.asarray(seq_len, dtype=np.int64)
    if s.size == 0:
        return np.zeros(0, dtype=np.float64)
    if s.min() < 0 or m.min() < 0 or s.max() >= (1 << 40) \
            or m.max() >= (1 << 24):
        return evalue(score, seq_len, db_res_count)  # cannot pack: exact path
    key = (s << 24) | m
    uniq, inv = np.unique(key, return_inverse=True)
    ev_u = evalue((uniq >> 24).astype(np.float64),
                  (uniq & ((1 << 24) - 1)).astype(np.float64),
                  db_res_count)
    return ev_u[inv]
