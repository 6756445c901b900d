"""ancient_correction: Bayesian per-base deamination polishing.

TPU-native re-design of src/assembler/correction.cpp.  Per query, aligned
reads are stacked into a (L, 4, 11) coverage tensor `count[pos, targetBase,
damageLayer]` (+ a reverse-orientation count), and the corrected base is

  argmax_q  sum_{t,l} count[p,t,l] * (log seqErr[t][obs_p] + logQ[p,q])
          + (count - rev)[p,t,l] * log max(deamFwd[l,q,t], 1e-3)
          + rev[p,t,l]          * log max(deamRev[l,q,t], 1e-3)

with logQ from the query's own damage layer (mostLikeliBaseRead,
correction.cpp:7-123).  All per-position math is a dense einsum over the
(L,4,11) stack — pure VPU work on TPU; NumPy here is the oracle/host path.

Replicated reference quirks:
* 'N' (or any non-ACGT char) folds to base 0 == 'A' in all maps
  (std::unordered_map operator[] default-insert).
* read filter: RY-identity >= dynamic threshold floor(((alnLen-1)/alnLen)
  *1000)/1000 for alnLen <= 100 else 0.99; contigs excluded; non-extending
  alignments only counted while average coverage < 50 (:294-323).
* accumulation additionally requires seqId >= seq_id_thr and alnLen >= 30
  (:359).
* positions with total coverage <= 1 pass through unchanged (:418); the
  C->T/G->A early-exit (ratios >= 0.4) returns the original base for
  uncorrected queries (:56-59).
* the identity self-alignment passes the filters and contributes one
  count per position.
"""
from __future__ import annotations

import numpy as np

from ..aligndb import AlnDB
from ..constants import CHAR_TO_ACGT, CHAR_TO_RY, SMOOTHING_VALUE
from ..damage import DamageModel, layer_index, seq_error_profile
from ..io.seqdb import SeqDB

_ACGT_BYTES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _canonicalize_alignments(aln: AlnDB, sl: slice):
    """Reverse-strand normalisation (correction.cpp:229-242): hits with
    qStart > qEnd get query coords swapped and db coords mirrored; returns
    per-record arrays for the query's record range."""
    qs = aln.cols["qstart"][sl].astype(np.int64).copy()
    qe = aln.cols["qend"][sl].astype(np.int64).copy()
    ts = aln.cols["dbstart"][sl].astype(np.int64).copy()
    te = aln.cols["dbend"][sl].astype(np.int64).copy()
    tl = aln.cols["dblen"][sl].astype(np.int64)
    rev = qs > qe
    qs2 = np.where(rev, qe, qs)
    qe2 = np.where(rev, qs, qe)
    ts2 = np.where(rev, tl - te - 1, ts)
    te2 = np.where(rev, tl - ts - 1, te)
    return qs2, qe2, ts2, te2, tl, rev


def prepare_correction_inputs(seqdb: SeqDB, aln: AlnDB, sym2_shape_n: int,
                              corr_reads_ry_seq_id: float, seq_id_thr: float):
    """Host-side: canonicalise records, apply sequence-free filters, build
    per-record arrays for the device correction kernel.  Mirrors stages/correction.py's
    filtering exactly (terminal/avCov gates, contig exclusion, seqId and
    alnLen gates; the RY gate runs on device)."""
    n = len(aln.qkey)
    qid = seqdb.lookup_keys(aln.qkey)
    tid = seqdb.lookup_keys(aln.cols["tkey"])
    qs = aln.cols["qstart"].astype(np.int64).copy()
    qe = aln.cols["qend"].astype(np.int64).copy()
    ts = aln.cols["dbstart"].astype(np.int64).copy()
    te = aln.cols["dbend"].astype(np.int64).copy()
    tl = aln.cols["dblen"].astype(np.int64)
    rev = qs > qe
    qs2 = np.where(rev, qe, qs)
    qe2 = np.where(rev, qs, qe)
    ts2 = np.where(rev, tl - te - 1, ts)
    te2 = np.where(rev, tl - ts - 1, te)
    alen = aln.aln_len.astype(np.int64)
    qlen = seqdb.lengths[qid]

    # avCov per query, broadcast per record
    av_num = np.zeros(len(seqdb), dtype=np.float64)
    np.add.at(av_num, qid, alen)
    av_cov = (av_num[qid] / seqdb.lengths[qid]).astype(np.float32)

    is_contig_t = seqdb.ext[tid]
    is_right = (ts2 == 0) & (qe2 == qlen - 1)
    is_left = (qs2 == 0) & (te2 == tl - 1)
    keep_pre = (~is_contig_t) & (is_right | is_left | (av_cov < 50)) \
        & (aln.cols["seq_id"] >= np.float32(seq_id_thr)) & (alen >= 30)

    thr = np.full(n, np.float32(corr_reads_ry_seq_id), dtype=np.float32)
    small = alen <= 100
    dyn = (alen[small].astype(np.float32) - 1) / alen[small].astype(np.float32)
    thr[small] = np.floor(dyn * np.float32(1000.0)) / np.float32(1000.0)

    # integer form of `f32(matches)/f32(alen) >= thr` (IEEE semantics): the
    # smallest match count that passes, found by probing numpy's f32
    # division around thr*alen.  The device then compares integers — immune
    # to XLA's reciprocal-multiply division (1 ulp off IEEE).
    base = np.floor(thr.astype(np.float64) * alen).astype(np.int64) - 2
    s_min = (alen + 1).astype(np.int64)          # "never passes" default
    al_f = alen.astype(np.float32)
    for d in range(6):
        cand = np.clip(base + d, 0, None)
        ok = (cand.astype(np.float32) / al_f) >= thr
        s_min = np.where(ok & (cand < s_min), cand, s_min)

    offsets = seqdb.offsets.astype(np.int64)
    return {
        "rec_q": qid.astype(np.int32),
        "rec_t_row": (tid + np.where(rev, sym2_shape_n, 0)).astype(np.int32),
        "rec_qstart": qs2.astype(np.int32),
        "rec_tstart": ts2.astype(np.int32),
        "rec_alen": alen.astype(np.int32),
        "rec_is_rev": rev,
        "rec_keep_pre": keep_pre,
        "rec_ry_smin": s_min.astype(np.int32),
        "rec_goffset": offsets[qid].astype(np.int32),
    }


def correction(seqdb: SeqDB, aln: AlnDB, damage: DamageModel,
               corr_reads_ry_seq_id: float, seq_id_thr: float) -> SeqDB:
    """Whole-DB host path: per-query-group coverage accumulation and
    argmax in one native C++ pass (native/prepass.cpp); the per-query
    NumPy oracle below transcribes correction.cpp directly.  The
    likelihood drops the per-position term_obs constant
    (argmax-invariant)."""
    from .. import native

    n = len(seqdb)
    total_len = int(seqdb.lengths.sum())
    rec = prepare_correction_inputs(seqdb, aln, n, corr_reads_ry_seq_id,
                                    seq_id_thr)

    # ---- native whole-stage path: per-query-group accumulation + argmax
    # in one C++ pass (no (total_len,4,11) global tensor) ---------------
    group_q = seqdb.lookup_keys(aln.qkeys).astype(np.int32)
    out_flat = native.correction_groups(
        seqdb.data[:total_len], seqdb.offsets, seqdb.lengths,
        seqdb.ext.astype(np.uint8), aln.starts, group_q,
        (rec["rec_t_row"] % max(n, 1)).astype(np.int32),
        rec["rec_is_rev"].astype(np.uint8), rec["rec_qstart"],
        rec["rec_tstart"], rec["rec_alen"],
        rec["rec_keep_pre"].astype(np.uint8), rec["rec_ry_smin"],
        np.log(seq_error_profile(0.01)),
        np.log(np.maximum(damage.fwd, SMOOTHING_VALUE)),
        np.log(np.maximum(damage.rev, SMOOTHING_VALUE)))
    return SeqDB.from_flat(out_flat, seqdb.lengths.copy(),
                           keys=seqdb.keys.copy(), ext=seqdb.ext.copy(),
                           headers=seqdb.headers)


def correction_per_query(seqdb: SeqDB, aln: AlnDB, damage: DamageModel,
                         corr_reads_ry_seq_id: float,
                         seq_id_thr: float) -> SeqDB:
    """Per-query NumPy oracle (direct transcription of correction.cpp)."""
    key2id = seqdb.key_to_id()
    seq_err = seq_error_profile(0.01)  # seqErrCorrection = 0.01 (:196)
    log_err = np.log(seq_err)                     # (t, obs)
    log_deam_f = np.log(np.maximum(damage.fwd, SMOOTHING_VALUE))  # (l,q,t)
    log_deam_r = np.log(np.maximum(damage.rev, SMOOTHING_VALUE))

    # per-query damage layer of each own position is computed on the fly
    out_seqs = []
    aln_by_key = {int(k): i for i, k in enumerate(aln.qkeys)}
    aln_len_all = aln.aln_len

    # precompute reverse-complemented byte views lazily per target
    from ..constants import CHAR_REVCOMP

    for i in range(len(seqdb)):
        qkey = int(seqdb.keys[i])
        qseq = seqdb.seq_bytes(i)
        L = int(seqdb.lengths[i])
        q_was_extended = bool(seqdb.ext[i])

        qi = aln_by_key.get(qkey)
        records = aln.records_for(qi) if qi is not None else slice(0, 0)
        nrec = records.stop - records.start
        if nrec == 0:
            out_seqs.append(bytes(qseq))
            continue

        qs, qe, ts, te, tlen, rev = _canonicalize_alignments(aln, records)
        alen = aln_len_all[records].astype(np.int64)
        tkeys = aln.cols["tkey"][records]
        seq_ids = aln.cols["seq_id"][records]
        av_cov = np.float32(alen.sum()) / np.float32(L)

        count = np.zeros((L, 4, 11), dtype=np.int64)
        rev_count = np.zeros((L, 4, 11), dtype=np.int64)
        total_cov = np.zeros(L, dtype=np.int64)

        q_ry = CHAR_TO_RY[qseq]
        for r in range(nrec):
            t_id = key2id[int(tkeys[r])]
            if seqdb.ext[t_id]:
                continue  # contigs never feed correction (:280-283)
            t_bytes = seqdb.seq_bytes(t_id)
            if rev[r]:
                t_bytes = CHAR_REVCOMP[t_bytes][::-1]
            a = int(alen[r])
            tw = t_bytes[ts[r]:ts[r] + a]
            qw = qseq[qs[r]:qs[r] + a]
            ry_id = np.float32((q_ry[qs[r]:qs[r] + a] == CHAR_TO_RY[tw]).sum()) \
                / np.float32(a)
            thresh = np.float32(corr_reads_ry_seq_id)
            if a <= 100:
                thresh = np.float32(a - 1) / np.float32(a)
                thresh = np.floor(thresh * np.float32(1000.0)) / np.float32(1000.0)
            if ry_id < thresh:
                continue
            is_right = ts[r] == 0 and qe[r] == L - 1
            is_left = qs[r] == 0 and te[r] == tlen[r] - 1
            if not (is_right or is_left or av_cov < 50):
                continue
            # accumulation filter (:359)
            if not (seq_ids[r] >= np.float32(seq_id_thr) and a >= 30):
                continue
            t_base = CHAR_TO_ACGT[tw]                      # N -> A quirk
            layers = layer_index(np.arange(ts[r], ts[r] + a), int(tlen[r]))
            posq = np.arange(qs[r], qs[r] + a)
            np.add.at(count, (posq, t_base, layers), 1)
            if rev[r]:
                np.add.at(rev_count, (posq, t_base, layers), 1)
            np.add.at(total_cov, posq, 1)

        # ---- per-position argmax --------------------------------------
        obs = CHAR_TO_ACGT[qseq]                           # (L,)
        base_covs = count.sum(axis=2)                      # (L, 4) per tBase
        tot = base_covs.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            ct_ratio = base_covs[:, 3] / tot
            ga_ratio = base_covs[:, 0] / tot

        own_layer = layer_index(np.arange(L), L)           # (L,)
        if q_was_extended:
            log_q = log_err[:, obs].T                      # (L, q)
        else:
            # logQBaseErr[q] = log(max(deam[layer(p)][q][obs_p], S))
            log_q = np.log(np.maximum(
                damage.fwd[own_layer[:, None],
                           np.arange(4)[None, :],
                           obs.astype(np.int64)[:, None]], SMOOTHING_VALUE))

        log_t = log_err[:, obs].T                          # (L, t) observation term
        fwd_minus = (count - rev_count).astype(np.float64)
        # lik[p,q] = sum_tl count*(log_t[p,t]) + tot[p]*log_q[p,q]
        #          + sum_tl (count-rev)*logF[l,q,t] + rev*logR[l,q,t]
        term_obs = np.einsum("ptl,pt->p", count.astype(np.float64), log_t)
        term_q = tot[:, None] * log_q                      # (L, q)
        term_f = np.einsum("ptl,lqt->pq", fwd_minus, log_deam_f)
        term_r = np.einsum("ptl,lqt->pq", rev_count.astype(np.float64),
                           log_deam_r)
        lik = term_obs[:, None] + term_q + term_f + term_r
        new_base = np.argmax(lik, axis=1)

        corrected = _ACGT_BYTES[new_base]
        if not q_was_extended:
            # ratio early-exit returns baseInQuery, re-encoded through
            # "ACGT" — an original 'N' becomes 'A' here (:56-59,:461)
            ratio_exit = (ct_ratio >= 0.4) | (ga_ratio >= 0.4)
            corrected = np.where(ratio_exit, _ACGT_BYTES[obs], corrected)
        out = np.where(total_cov <= 1, qseq, corrected)
        out_seqs.append(out.tobytes())

    return SeqDB.from_sequences(out_seqs, keys=seqdb.keys.copy(),
                                ext=seqdb.ext.copy(), headers=seqdb.headers)
