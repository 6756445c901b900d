"""rescorediagonal: ungapped end-to-end rescoring of candidate overlaps.

TPU-native re-design of lib/mmseqs/src/alignment/rescorediagonal.cpp for
RESCORE_MODE_END_TO_END_ALIGNMENT (mode 4, the mode every assembly step
uses).  Instead of a per-hit scalar scan, all (query, target, diagonal)
candidates are scored as one batch: on the host by the native per-pair
scan (native/host_kernels.cpp), on the card by the rescore kernel
(ops/rescore_cuda.py); both feed assemble_alndb below.

Reference semantics replicated:
* prefilter diagonals travel as unsigned short; scoring tries the two
  candidate real diagonals d-65536 and d (DistanceCalculator::
  computeUngappedAlignment, DistanceCalculator.h:93-113), keeping the
  strictly-better one (ties favour the negative candidate).
* end-to-end score = sum of +2 match / -3 mismatch over the full overlap,
  clamped at 0 (computeGlobalSubstitutionStartEndDistance, :204-220).
* if no candidate scores > 0 the default LocalAlignment survives:
  startPos = endPos = -1, diagonal = 0 (rescorediagonal.cpp:214-234) —
  coords become (-1,-1) and alnLen 1.
* e-value & bit score via the ALP Gumbel stats; seqId is computed only
  when evalue <= threshold or the hit is the identity (:276-284), as
  case-folded char equality over the query window / alnLen.
* reverse-strand hits score against the reversed query (built with
  num2aa, so non-ACGT chars become 'X', :173-179) and have their query
  coords flipped after coverage computation (:294-297).
"""
from __future__ import annotations

import numpy as np

from .. import evalue as ev
from ..aligndb import AlnDB, PrefDB, cpp_eval_roundtrip, cpp_truncate_seqid
from ..io.seqdb import SeqDB

_EPS = np.float32(np.finfo(np.float32).eps)


def rescorediagonal(seqdb: SeqDB, pref: PrefDB, seq_id_thr: float,
                    eval_thr: float = 0.001, aln_len_thr: int = 0) -> AlnDB:
    """Score every prefilter hit and emit filtered alignment records.

    Host path: the native C++ per-pair scan (native/host_kernels.cpp).
    ops.rescore_cuda.rescorediagonal_cuda is the device drop-in sharing
    assemble_alndb below."""
    raw = _score_pairs_native(seqdb, pref)
    return assemble_alndb(seqdb, pref, raw, seq_id_thr, eval_thr,
                          aln_len_thr)


def _score_pairs_native(seqdb: SeqDB, pref: PrefDB) -> dict:
    from .. import native

    qid = seqdb.lookup_keys(pref.qkey).astype(np.int32)
    tid = seqdb.lookup_keys(pref.tkey).astype(np.int32)
    out = native.score_pairs(seqdb.data, seqdb.offsets, seqdb.lengths,
                             qid, tid, pref.diag.astype(np.int32),
                             (pref.score < 0).astype(np.uint8))
    out["qlen"] = seqdb.lengths[qid].astype(np.int64)
    out["tlen"] = seqdb.lengths[tid].astype(np.int64)
    return out


def assemble_alndb(seqdb: SeqDB, pref: PrefDB, raw: dict, seq_id_thr: float,
                   eval_thr: float, aln_len_thr: int) -> AlnDB:
    """Statistics + filters + per-query record assembly over the raw
    per-pair scoring arrays (from the NumPy or device scorer)."""
    db_res = seqdb.total_residues
    qid = seqdb.lookup_keys(pref.qkey)
    tid = seqdb.lookup_keys(pref.tkey)
    is_rev = pref.score < 0
    best_score = raw["score"].astype(np.int64)
    qstart = raw["qstart"].astype(np.int64)
    qend = raw["qend"].astype(np.int64)
    tstart = raw["tstart"].astype(np.int64)
    tend = raw["tend"].astype(np.int64)
    aln_len = raw["aln_len"].astype(np.int64)
    id_cnt = raw["id_cnt"].astype(np.int64)
    qlen = raw["qlen"].astype(np.int64)
    tlen = raw["tlen"].astype(np.int64)

    # ---- statistics ------------------------------------------------------
    evals = ev.evalue_grouped(best_score, qlen, db_res)
    bits = ev.bit_score_int(best_score.astype(np.float64))
    is_identity = qid == tid

    # seqId is computed only when evalue <= threshold or identity (:276-284)
    need_seqid = (evals <= eval_thr) | is_identity
    seq_id = np.where(need_seqid & (aln_len > 0),
                      id_cnt.astype(np.float32) / np.maximum(aln_len, 1)
                      .astype(np.float32),
                      np.float32(0.0)).astype(np.float32)

    # ---- filters (rescorediagonal.cpp:306-314) ---------------------------
    has_seqid = seq_id >= (np.float32(seq_id_thr) - _EPS)
    has_eval = evals <= eval_thr
    has_alnlen = aln_len >= aln_len_thr
    emit = is_identity | (has_alnlen & has_seqid & has_eval)

    # reverse hits: flip query coords (after covs, which we don't store)
    qstart_out = np.where(is_rev, qlen - qstart - 1, qstart)
    qend_out = np.where(is_rev, qlen - qend - 1, qend)

    # ---- assemble output in per-query record order -----------------------
    # records are grouped by query in pref order, so the emitted indices in
    # ascending order ARE the output order; per-query group sizes come from
    # one searchsorted (the reference writes an empty record for hit-less
    # queries, so every query keeps an entry in qkeys/starts)
    order = np.nonzero(emit)[0]
    qi_of = np.searchsorted(pref.starts[1:], order, side="right")
    counts_q = np.bincount(qi_of, minlength=len(pref.qkeys))
    starts_out = np.concatenate([[0], np.cumsum(counts_q)])

    return AlnDB.from_arrays(
        qkey=pref.qkey[order], qkeys=pref.qkeys.astype(np.uint32),
        starts=starts_out.astype(np.int64),
        tkey=pref.tkey[order],
        score=bits[order],
        seq_id=cpp_truncate_seqid(seq_id[order]),
        eval=cpp_eval_roundtrip(evals[order]) if len(order) else np.zeros(0),
        qstart=qstart_out[order], qend=qend_out[order], qlen=qlen[order],
        dbstart=tstart[order], dbend=tend[order], dblen=tlen[order])
