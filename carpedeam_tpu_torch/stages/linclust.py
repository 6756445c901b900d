"""linclust-equivalent redundancy reduction.

Re-design of the reference's linclust pipeline as invoked by the guided
workflow (lib/mmseqs/data/workflow/linclust.sh with the CLUSTER_PAR of
src/workflow/GuidedNuclassembler.cpp:33-40,175-180):

  1. kmermatcher          (k=20, cov-mode 1, -c 0.99)
  2. rescorediagonal      (HAMMING + wrapped scoring, seqId 0.97, cov 0.99)
  3. clust                (greedy incremental, length-ranked ids)
  4. createsubdb/filterdb (representatives only)
  5. align                (gapped nucleotide alignment: ungapped end-to-end
                           scoring on the candidate diagonals first, then a
                           banded affine-gap rescue [ops/banded_align.py,
                           the BandedNucleotideAligner/ksw2 role] for pairs
                           that fail ungapped but could still reach the
                           coverage threshold within the band)
  6. clust + mergeclusters

Steps 2 and 5 run the native OpenMP batch kernels
(native/linclust_kernels.cpp) with vectorised thresholding.

Returns {representative_key: [member keys]} (cluster records in the
reference's format: rep first, members ascending).
"""
from __future__ import annotations

import numpy as np

from ..aligndb import PrefDB
from ..constants import CHAR_TO_CODE, COMPLEMENT_CODE
from ..io.seqdb import SeqDB
from ..kmer.matcher import kmermatcher
from .. import evalue as ev

_DECODE_X = np.frombuffer(b"ACTGX", dtype=np.uint8)
_CHAR_REVCOMP_X = _DECODE_X[COMPLEMENT_CODE[CHAR_TO_CODE]]
_EPS = np.float32(np.finfo(np.float32).eps)


def length_rank_ids(seqdb: SeqDB) -> np.ndarray:
    """Internal ids under SORT_BY_LENGTH: stable sort by record byte length
    (seqLen + 2) descending, ties by original index ascending
    (DBReader.cpp:301-318).  Returns rank[orig_index]."""
    order = np.lexsort((np.arange(len(seqdb)),
                        -(seqdb.lengths + 2)))
    rank = np.empty(len(seqdb), dtype=np.int64)
    rank[order] = np.arange(len(seqdb))
    return rank


def _cov_ok(qcov, tcov, cov_thr, cov_mode):
    if cov_mode == 1:
        return tcov >= cov_thr
    if cov_mode == 2:
        return qcov >= cov_thr
    return (qcov >= cov_thr) & (tcov >= cov_thr)


def _group_starts(pref: PrefDB, keep: np.ndarray) -> np.ndarray:
    """Per-query output starts after filtering records with `keep`."""
    cum = np.concatenate([[0], np.cumsum(keep.astype(np.int64))])
    return cum[pref.starts]


def hamming_wrapped_rescore(seqdb: SeqDB, pref: PrefDB, seq_id_thr: float,
                            cov_thr: float, cov_mode: int) -> PrefDB:
    """rescorediagonal with RESCORE_MODE_HAMMING + --wrapped-scoring:
    score = 100*seqId (sign = strand), diagonal from the best wrapped
    placement (rescorediagonal.cpp:162-167,215-225,243-246,319-331).

    Production path: one native OpenMP pass over all prefilter records
    (native/linclust_kernels.cpp) + vectorised thresholding."""
    from .. import native
    if len(pref.qkey) == 0:
        return pref
    qid_r = seqdb.lookup_keys(pref.qkey)
    tid_r = seqdb.lookup_keys(pref.tkey)
    is_rev = pref.score < 0
    diag_u = (pref.diag & 0xFFFF).astype(np.uint16)
    res = native.linclust_wrapped_rescore(
        seqdb.data, seqdb.offsets, seqdb.lengths, qid_r, tid_r, diag_u,
        is_rev)
    best_score, best_diag, valid = res[:, 0], res[:, 1], res[:, 2]
    L = seqdb.lengths[qid_r]
    tlen = seqdb.lengths[tid_r]
    dlen = np.minimum(tlen, L)
    seq_id = best_score.astype(np.float32) / dlen.astype(np.float32)
    qcov = dlen.astype(np.float32) / L.astype(np.float32)
    tcov = dlen.astype(np.float32) / tlen.astype(np.float32)
    has_seqid = seq_id >= (np.float32(seq_id_thr) - _EPS)
    keep = (valid == 1) & ((qid_r == tid_r)
                           | (_cov_ok(qcov, tcov, np.float32(cov_thr),
                                      cov_mode) & has_seqid))
    score100 = (100.0 * seq_id.astype(np.float64)).astype(np.int64)
    score_out = np.where(is_rev, -score100, score100).astype(np.int32)
    diag_out = best_diag.astype(np.int16).astype(np.int32)
    return PrefDB(
        qkey=pref.qkey[keep].astype(np.uint32),
        tkey=pref.tkey[keep].astype(np.uint32),
        score=score_out[keep],
        diag=diag_out[keep],
        starts=_group_starts(pref, keep),
        qkeys=np.asarray(pref.qkeys, dtype=np.uint32))


def greedy_incremental_cluster(seqdb: SeqDB, pref: PrefDB) -> dict[int, list[int]]:
    """ClusteringAlgorithms::greedyIncrementalLowMem: every member is
    assigned the minimum length-rank id among itself and all queries that
    list it; referenced reps are forced to be their own rep
    (ClusteringAlgorithms.cpp:271-332).

    Vectorised: the sequential `if q_rank < assigned[m_rank]` edge sweep
    is exactly an unbuffered minimum-scatter (np.minimum.at), and the
    rep-correction pass reduces to self-assigning every value that
    appears in `assigned` (any rep referenced by a member becomes its
    own rep; order effects of the sequential loop cancel)."""
    rank = length_rank_ids(seqdb)
    n = len(seqdb)
    assigned = np.arange(n, dtype=np.int64)  # by rank id: self-assignment
    if len(pref.qkey):
        q_ranks_per_query = rank[seqdb.lookup_keys(pref.qkeys)]
        q_ranks = np.repeat(q_ranks_per_query, np.diff(pref.starts))
        m_ranks = rank[seqdb.lookup_keys(pref.tkey)]
        np.minimum.at(assigned, m_ranks, q_ranks)
    reps = np.unique(assigned)
    assigned[reps] = reps
    # build clusters keyed by rep KEY, members ascending by key
    # (assignment pairs sorted by (repKey, memberKey); Clustering::writeData)
    order = np.empty(n, dtype=np.int64)
    order[rank] = np.arange(n)                    # rank -> original row
    key_of_rank = seqdb.keys[order].astype(np.int64)
    rep_key_arr = key_of_rank[assigned]
    sort2 = np.lexsort((key_of_rank, rep_key_arr))
    rep_sorted = rep_key_arr[sort2]
    mem_sorted = key_of_rank[sort2]
    uniq, group_start = np.unique(rep_sorted, return_index=True)
    bounds = np.append(group_start, n)
    clusters: dict[int, list[int]] = {}
    for gi, rep_key in enumerate(uniq.tolist()):
        mem = mem_sorted[bounds[gi]:bounds[gi + 1]].tolist()
        clusters[rep_key] = [rep_key] + [m for m in mem if m != rep_key]
    return clusters


#: half-width of the banded gapped rescue (ops/banded_align.py default)
_RESCUE_BAND = 64


def align_filter(seqdb: SeqDB, pref: PrefDB, seq_id_thr: float,
                 cov_thr: float, cov_mode: int, eval_thr: float) -> PrefDB:
    """The `align` stage reduced to its filtering role: re-align each pair
    on its diagonal end-to-end, keep pairs passing seqId/cov/evalue.
    Returns a PrefDB with the surviving pairs (cluster edges).

    Production path: native batch best-diagonal scoring + vectorised
    thresholds; the banded gapped rescue (ksw2 role) runs only for pairs
    that fail ungapped AND could still reach the coverage threshold
    within the ±64 band — spurious prefilter pairs whose overlap window
    is too small to ever cover the target are rejected without paying
    the DP."""
    from .. import native
    if len(pref.qkey) == 0:
        return pref
    qid_r = seqdb.lookup_keys(pref.qkey)
    tid_r = seqdb.lookup_keys(pref.tkey)
    is_rev = pref.score < 0
    diag_u = (pref.diag & 0xFFFF).astype(np.uint16)
    res = native.linclust_align_best(
        seqdb.data, seqdb.offsets, seqdb.lengths, qid_r, tid_r, diag_u,
        is_rev)
    score, cand, n_w, ids, valid = (res[:, i] for i in range(5))
    L = seqdb.lengths[qid_r]
    tlen = seqdb.lengths[tid_r]
    db_res = seqdb.total_residues
    thr32 = np.float32(seq_id_thr) - _EPS
    cov32 = np.float32(cov_thr)

    def passes(sid, n_q, n_t, sc):
        qcov = n_q.astype(np.float32) / L.astype(np.float32)
        tcov = n_t.astype(np.float32) / tlen.astype(np.float32)
        e = ev.evalue_grouped(sc, L, db_res)
        return _cov_ok(qcov, tcov, cov32, cov_mode) & (sid >= thr32) \
            & (e <= eval_thr)

    nf = np.maximum(n_w, 1)
    sid_u = ids.astype(np.float32) / nf.astype(np.float32)
    accept = (valid == 1) & (score > 0) & passes(sid_u, n_w, n_w, score)
    score_out = score.astype(np.int64)

    # gapped rescue, gated by band-reachability of the coverage threshold
    fail = (valid == 1) & ~accept
    dist = np.abs(cand.astype(np.int64))
    q_sub_len = np.where(cand >= 0, L - dist, L)
    t_sub_len = np.where(cand >= 0, tlen, tlen - dist)
    max_nt = np.minimum(t_sub_len, q_sub_len + _RESCUE_BAND)
    max_nq = np.minimum(q_sub_len, t_sub_len + _RESCUE_BAND)
    gate = _cov_ok(max_nq.astype(np.float32) / L.astype(np.float32),
                   max_nt.astype(np.float32) / tlen.astype(np.float32),
                   cov32, cov_mode)
    for r in np.nonzero(fail & gate)[0]:
        from ..ops.banded_align import banded_align
        qbytes = np.asarray(seqdb.seq_bytes(qid_r[r]), dtype=np.uint8)
        qb = _CHAR_REVCOMP_X[qbytes][::-1] if is_rev[r] else qbytes
        tbytes = np.asarray(seqdb.seq_bytes(tid_r[r]), dtype=np.uint8)
        d = int(dist[r])
        if cand[r] >= 0:
            q_sub, t_sub = qb[d:], tbytes
        else:
            q_sub, t_sub = qb, tbytes[d:]
        s2, qe2, te2, id2, alen2 = banded_align(
            CHAR_TO_CODE[q_sub], CHAR_TO_CODE[t_sub])
        if s2 > 0 and alen2 > 0:
            sid2 = np.float32(id2) / np.float32(alen2)
            qcov2 = np.float32(qe2 + 1) / np.float32(L[r])
            tcov2 = np.float32(te2 + 1) / np.float32(tlen[r])
            e2 = float(ev.evalue(float(s2), float(L[r]), db_res))
            if bool(_cov_ok(qcov2, tcov2, cov32, cov_mode)) \
                    and sid2 >= thr32 and e2 <= eval_thr:
                accept[r] = True
                score_out[r] = s2

    # wrapped (circular) gapped rescue: the guided path's align stage
    # runs the banded nucleotide aligner with --wrapped-scoring
    # (GuidedNuclassembler.cpp:179; BandedNucleotideAligner.cpp:100-110):
    # the query is doubled and the banded alignment anchors on the best
    # LOCAL-score wrapped placement of the prefilter diagonal
    # (DistanceCalculator::computeUngappedWrappedAlignment), so overlaps
    # crossing the query's end-start junction can still cluster.
    fail2 = np.nonzero((valid == 1) & ~accept & (tlen <= L))[0]
    for r in fail2:
        qbytes = np.asarray(seqdb.seq_bytes(qid_r[r]), dtype=np.uint8)
        qb = _CHAR_REVCOMP_X[qbytes][::-1] if is_rev[r] else qbytes
        tbytes = np.asarray(seqdb.seq_bytes(tid_r[r]), dtype=np.uint8)
        q2 = CHAR_TO_CODE[np.concatenate([qb, qb])]
        res = native.wrapped_banded_align(q2, CHAR_TO_CODE[tbytes],
                                          int(diag_u[r]))
        aln_len2 = res["aln_len"]
        if aln_len2 <= 0:
            continue
        # Matcher::getSWResult / Alignment::checkCriteria acceptance:
        # seqId = aaIds/backtraceLen, covs from the alignment ends with
        # the wrapped qCov doubling (BandedNucleotideAligner.cpp:217-223)
        sid2 = np.float32(res["aa_ids"]) / np.float32(aln_len2)
        qcov2 = np.float32(res["qend"] - res["qstart"] + 1) \
            / np.float32(2 * L[r])
        qcov2 = min(np.float32(1.0), qcov2 * np.float32(2.0))
        tcov2 = np.float32(res["tend"] - res["tstart"] + 1) \
            / np.float32(tlen[r])
        e2 = float(ev.evalue(float(res["score"]), float(L[r]), db_res))
        if bool(_cov_ok(qcov2, tcov2, cov32, cov_mode)) \
                and float(sid2) >= seq_id_thr and e2 <= eval_thr:
            accept[r] = True
            score_out[r] = res["score"]
    keep = accept | (valid == 2)
    score_final = np.where(valid == 2, (2 * L).astype(np.int64),
                           score_out).astype(np.int32)
    diag_final = np.where(valid == 2, 0,
                          cand.astype(np.int16).astype(np.int32))
    return PrefDB(
        qkey=pref.qkey[keep].astype(np.uint32),
        tkey=pref.tkey[keep].astype(np.uint32),
        score=score_final[keep],
        diag=diag_final[keep].astype(np.int32),
        starts=_group_starts(pref, keep),
        qkeys=np.asarray(pref.qkeys, dtype=np.uint32))


def linclust(seqdb: SeqDB, clust_seq_id_thr: float = 0.97,
             clust_cov_thr: float = 0.99, cov_mode: int = 1,
             kmer_size: int = 20) -> dict[int, list[int]]:
    """Full redundancy-reduction pipeline -> {rep key: [member keys]}."""
    pref = kmermatcher(seqdb, kmer_size, 200, 0.2,
                       include_only_extendable=False,
                       cov_mode=cov_mode, cov_thr=clust_cov_thr)
    # hamming thresholds: max(0.5, thr) (Linclust.cpp:107-113)
    rescore1 = hamming_wrapped_rescore(
        seqdb, pref, max(0.5, clust_seq_id_thr), max(0.5, clust_cov_thr),
        cov_mode)
    pre_clust = greedy_incremental_cluster(seqdb, rescore1)

    # representatives sub-database
    rep_keys = sorted(pre_clust.keys())
    key2id = seqdb.key_to_id()
    rep_db = seqdb.select(np.array([key2id[k] for k in rep_keys],
                                   dtype=np.int64))
    # pref filtered to rep queries and rep targets (vectorised)
    rep_arr = np.array(rep_keys, dtype=np.int64)
    q_is_rep = np.isin(pref.qkeys.astype(np.int64), rep_arr)
    rec_q_is_rep = np.repeat(q_is_rep, np.diff(pref.starts))
    keep = rec_q_is_rep & np.isin(pref.tkey.astype(np.int64), rep_arr)
    cum = np.concatenate([[0], np.cumsum(keep.astype(np.int64))])
    counts = cum[pref.starts[1:]] - cum[pref.starts[:-1]]
    pref2 = PrefDB(pref.qkey[keep], pref.tkey[keep], pref.score[keep],
                   pref.diag[keep],
                   np.concatenate([[0], np.cumsum(counts[q_is_rep])])
                   .astype(np.int64),
                   pref.qkeys[q_is_rep].astype(np.uint32))

    aln = align_filter(rep_db, pref2, clust_seq_id_thr, clust_cov_thr,
                       cov_mode, 0.001)
    clust2 = greedy_incremental_cluster(rep_db, aln)

    # mergeclusters: compose
    merged: dict[int, list[int]] = {}
    for rep, members in clust2.items():
        out = []
        for m in members:
            out.extend(pre_clust[m])
        merged[rep] = out
    return merged
