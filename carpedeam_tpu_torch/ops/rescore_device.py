"""`--use-device 1` rescoring: ungapped end-to-end scoring of every
prefilter pair as tensor programs (row gathers and windowed gathers of
the sequence planes) on `device`.

Port of carpedeam_tpu/ops/rescore_tpu.py: `rescore_pairs_device` (:195)
and `rescorediagonal_tpu` (:267, here `rescorediagonal_device`), which
the JAX package runs for accelerators that are not TPUs.  The statistics,
filters and record assembly are the host code that the kernel route
shares (stages/rescorediagonal.assemble_alndb).  The JAX program pads the
pair axis to reuse its compilations; padding changes no output, so the
port has none.  Pairs are scored in chunks that bound the (pairs x L)
window tensors; chunking changes no output either.

Planes narrower than the longest sequence would cut its windows: the
JAX function scores them so when its caller passes the pipeline's
512-wide planes (the windows are clipped to the plane), which differs
from the host scorer.  Here such planes are not used: the stage packs
planes as wide as its longest sequence, as the JAX function does when
it gets none.
"""
from __future__ import annotations

import numpy as np
import torch

from .planes import device_planes, to_device

# window elements per chunk of pairs (pairs x plane width)
CHUNK_ELEMS = 1 << 24


def rescore_pairs_device(code2, sym2, lengths, qidx, tidx, diag16, is_rev
                         ) -> dict:
    """Scores of all pairs: code2/sym2 the (2N, L) uint8 stacked planes,
    lengths (N,), qidx/tidx/diag16 (P,) integer tensors and is_rev (P,)
    bool on the planes' device.  Returns per-pair int64 tensors score,
    qstart, qend, tstart, tend, aln_len, id_cnt, qlen, tlen."""
    L = code2.shape[1]
    step = max(1, CHUNK_ELEMS // max(L, 1))
    parts = [_score_chunk(code2, sym2, lengths, qidx[i:i + step],
                          tidx[i:i + step], diag16[i:i + step],
                          is_rev[i:i + step])
             for i in range(0, max(qidx.shape[0], 1), step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _score_chunk(code2, sym2, lengths, qidx, tidx, diag16, is_rev) -> dict:
    """rescore_pairs_device over one chunk of pairs
    (carpedeam_tpu/ops/rescore_tpu.py:195-264, step by step)."""
    max_len = code2.shape[1]
    n_seqs = lengths.shape[0]
    qidx = qidx.to(torch.int64)
    tidx = tidx.to(torch.int64)
    lens = lengths.to(torch.int64)
    qlen = lens[qidx]
    tlen = lens[tidx]
    qrow = qidx + torch.where(is_rev, n_seqs, 0)
    diag_u = diag16.to(torch.int64) & 0xFFFF
    pos = torch.arange(max_len, dtype=torch.int64,
                       device=code2.device)[None, :]

    q_code_rows = code2[qrow]
    t_code_rows = code2[tidx]
    q_sym_rows = sym2[qrow]
    t_sym_rows = sym2[tidx]

    def windows(rows, offsets):
        return torch.gather(rows, 1, torch.clamp(offsets, 0, max_len - 1))

    def score_candidate(cand):
        neg = cand < 0
        dist = torch.abs(cand)
        valid = torch.where(neg, dist < tlen, dist < qlen)
        min_len = torch.where(neg, torch.minimum(tlen - dist, qlen),
                              torch.minimum(tlen, qlen - dist))
        min_len = torch.where(valid, min_len, 0)
        qoff = torch.where(neg, 0, dist)[:, None] + pos
        toff = torch.where(neg, dist, 0)[:, None] + pos
        in_win = pos < min_len[:, None]
        qc = windows(q_code_rows, qoff)
        tc = windows(t_code_rows, toff)
        match = (qc == tc) & (qc < 4) & in_win
        m = match.sum(dim=1)
        score = torch.clamp(2 * m - 3 * (min_len - m), min=0)
        return torch.where(valid, score, 0), min_len

    cand_neg = diag_u - 65536
    cand_pos = diag_u
    s_neg, len_neg = score_candidate(cand_neg)
    s_pos, len_pos = score_candidate(cand_pos)

    use_pos = s_pos > s_neg
    best_score = torch.where(use_pos, s_pos, s_neg)
    best_cand = torch.where(use_pos, cand_pos, cand_neg)
    best_len = torch.where(use_pos, len_pos, len_neg)
    got = best_score > 0
    best_dist = torch.abs(best_cand)
    start = torch.where(got, 0, -1)
    end = torch.where(got, best_len - 1, -1)
    dist = torch.where(got, best_dist, 0)
    dneg = got & (best_cand < 0)

    qstart = torch.where(dneg, start, start + dist)
    qend = torch.where(dneg, end, end + dist)
    tstart = torch.where(dneg, start + dist, start)
    tend = torch.where(dneg, end + dist, end)
    aln_len = end - start + 1

    in_win = pos < aln_len[:, None]
    qs = windows(q_sym_rows, qstart[:, None] + pos)
    ts = windows(t_sym_rows, tstart[:, None] + pos)
    id_cnt = ((qs == ts) & in_win).sum(dim=1)

    return {"score": best_score, "qstart": qstart, "qend": qend,
            "tstart": tstart, "tend": tend, "aln_len": aln_len,
            "id_cnt": id_cnt, "qlen": qlen, "tlen": tlen}


def full_width_planes(seqdb, planes, lengths, device):
    """(planes, lengths) at least as wide as the longest sequence: the
    given ones when they are, else a fresh pack on `device` (or on the
    given planes' device)."""
    from ..utils import bucket_len, resolve_device
    longest = int(seqdb.lengths.max()) if len(seqdb) else 1
    if planes is not None and planes["code"].shape[1] >= longest:
        return planes, lengths
    dev = planes["code"].device if planes is not None \
        else resolve_device(device)
    return device_planes(seqdb, max_len=bucket_len(longest), device=dev)


def rescorediagonal_device(seqdb, pref, seq_id_thr, eval_thr=0.001,
                           aln_len_thr=0, planes=None, lengths=None,
                           device="cuda"):
    """The `--use-device 1` drop-in for stages.rescorediagonal.
    rescorediagonal: the (pairs, L) window scans run as tensor programs
    on `device` (the planes' device when planes are given); statistics,
    filters and record assembly share the host code (the integer
    id_cnt crosses over, so the float semantics stay IEEE-exact)."""
    from ..stages.rescorediagonal import assemble_alndb
    from ..utils import coverage_add

    planes, lengths = full_width_planes(seqdb, planes, lengths, device)
    dev = planes["code"].device
    n = len(pref.qkey)
    qidx = seqdb.lookup_keys(pref.qkey)
    tidx = seqdb.lookup_keys(pref.tkey)
    out = rescore_pairs_device(
        planes["code"], planes["sym"], to_device(np.asarray(lengths), dev),
        to_device(qidx, dev), to_device(tidx, dev),
        to_device(pref.diag.astype(np.int64), dev),
        to_device(pref.score < 0, dev))
    raw = {k: v.cpu().numpy() for k, v in out.items()}
    coverage_add("rescorediagonal", n, 0)
    return assemble_alndb(seqdb, pref, raw, seq_id_thr, eval_thr,
                          aln_len_thr)


def evalue_device(score: torch.Tensor, seq_len: torch.Tensor,
                  db_res_count) -> torch.Tensor:
    """The gapless e-value in f32 on the scores' device, the counterpart
    of carpedeam_tpu/ops/rescore_tpu.py::evalue_device (:309): evalue.py's
    closed form with torch.special.erfc in place of
    jax.scipy.special.erfc.  The pipeline computes its e-values on the
    host (evalue.py, f64); this is the device form of the same formula."""
    from .. import evalue as ev
    y = score.to(torch.float32)
    m = seq_len.to(torch.float32)
    n = torch.as_tensor(db_res_count, dtype=torch.float32, device=y.device)
    y_thr = 2.0 * ev.ALPHA_FSC / ev.LAMBDA
    inv_sqrt_2pi = 1.0 / np.sqrt(2.0 * np.pi)

    def phi(x):
        return 0.5 * torch.special.erfc(-float(np.sqrt(0.5)) * x)

    m_li = m - ev.A_FSC * y
    vi = torch.clamp(ev.ALPHA_FSC * y, min=y_thr)
    sq = torch.sqrt(vi)
    m_f = m_li / sq
    p_m = phi(m_f)
    e_m = -inv_sqrt_2pi * torch.exp(-0.5 * m_f * m_f)
    p1 = m_li * p_m - sq * e_m
    n_lj = n - ev.A_FSC * y
    n_f = n_lj / sq
    p_n = phi(n_f)
    e_n = -inv_sqrt_2pi * torch.exp(-0.5 * n_f * n_f)
    p2 = n_lj * p_n - sq * e_n
    area = p1 * p2 + vi * p_m * p_n     # c_y == vi for gapless parameters
    return ev.K * torch.exp(-ev.LAMBDA * y) * area
