"""ancient_contig_merge: Beta-posterior greedy contig merging.

Re-design of src/assembler/ancientContigsResults.cpp (doNuclAssembly2).
Unlike the read phase, reverse-strand overlaps participate: alignments are
canonicalised first (coords swapped + target reverse-complemented), and
candidates require seqId >= merge threshold (0.99) AND RY-space identity
>= 0.99 with a minimum anchor length min(500, 0.2*dbLen).

Candidates are ranked by a damage-discounted match count
(`ancientMatchCount`, nuclassembleUtil.cpp:1050-1182): the +2/-3 score
recomputed from the consensus seqId, plus per-column posteriors that each
C->T / G->A column is a true match (`deamMatches`, :1011-1047).  The
priority queue compares two candidates by the Beta-distribution posterior
P(p1 > p2) over their damage-corrected mismatch counts, evaluated with an
lgamma series (ancientContigsResults.cpp:25-70).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

from ..aligndb import AlnDB
from ..constants import CHAR_REVCOMP, CHAR_TO_ACGT, CHAR_TO_RY
from ..damage import DamageModel
from ..io.seqdb import SeqDB
from ..ops.likelihood import CppPriorityQueue
from .read_assembly import _ungapped_realign


class _Cand:
    __slots__ = ("tkey", "qstart", "qend", "qlen", "tstart", "tend", "tlen",
                 "aln_len", "seq_id", "ry_seq_id", "is_rev", "deam_match",
                 "aln_len_cons")

    def __init__(self, tkey, qstart, qend, qlen, tstart, tend, tlen, aln_len,
                 is_rev):
        self.tkey = tkey
        self.qstart, self.qend, self.qlen = qstart, qend, qlen
        self.tstart, self.tend, self.tlen = tstart, tend, tlen
        self.aln_len = aln_len
        self.is_rev = is_rev
        self.seq_id = 0.0
        self.ry_seq_id = 0.0
        self.deam_match = 0.0
        self.aln_len_cons = 0


_libm_f = ctypes.CDLL("libm.so.6")
_libm_f.lgammaf.restype = ctypes.c_float
_libm_f.lgammaf.argtypes = (ctypes.c_float,)
_libm_f.logf.restype = ctypes.c_float
_libm_f.logf.argtypes = (ctypes.c_float,)


def _lgammaf(x) -> np.float32:
    return np.float32(_libm_f.lgammaf(ctypes.c_float(float(x))))


def _logf(x) -> np.float32:
    return np.float32(_libm_f.logf(ctypes.c_float(float(x))))


def _beta_less(r1: _Cand, r2: _Cand) -> bool:
    """CompareNuclResultByScoreContigs (ancientContigsResults.cpp:25-70)
    with the reference's EXACT overload resolution: under libgab.h's
    `using namespace std`, lgamma/log of the FLOAT alpha/beta sums are
    lgammaf/logf (only log(idx+1), integral, is double).  The f32 lgamma
    moves p by ~1e-5 — enough to decide gray-zone [0.45, 0.55] pairs."""
    mm1 = np.float32(r1.aln_len_cons) - np.float32(r1.deam_match)
    mm2 = np.float32(r2.aln_len_cons) - np.float32(r2.deam_match)
    alpha1 = np.float32(mm1 + np.float32(1))
    alpha2 = np.float32(mm2 + np.float32(1))
    beta1 = np.float32(np.float32(r1.deam_match) + np.float32(1))
    beta2 = np.float32(np.float32(r2.deam_match) + np.float32(1))
    log_c = float(np.float32(
        np.float32(_lgammaf(beta1 + beta2) + _lgammaf(alpha1 + beta1))
        - np.float32(_lgammaf(alpha1 + beta1 + beta2) + _lgammaf(beta1))))
    log_r = 0.0
    p = 0.0
    idx = 0
    while np.float32(idx) < alpha2:
        p += math.exp(log_r + log_c)
        ab = np.float32(_logf(alpha1 + np.float32(idx))
                        + _logf(beta2 + np.float32(idx)))
        cd = math.log(idx + 1) + float(_logf(
            np.float32(idx) + alpha1 + beta1 + beta2))
        log_r = (float(ab) - cd) + log_r
        idx += 1
    if p < 0.45:
        return True
    if p > 0.55:
        return False
    if r1.aln_len_cons < r2.aln_len_cons:
        return True
    if r1.aln_len_cons > r2.aln_len_cons:
        return False
    return True


def _update_vs_consensus(c: _Cand, consensus: np.ndarray, query_len: int,
                         target: np.ndarray):
    """updateSeqIdConsensus (contig flavour): sets seqId, rySeqId AND
    alnLengthCons = totalCnt (nuclassembleUtil.cpp:704-794)."""
    tlen = c.tlen
    right_start = c.tstart == 0 and c.qend == query_len - 1
    left_start = c.qstart == 0 and c.tend == tlen - 1
    offset = tlen - c.aln_len
    consensus_start = query_len - offset
    if (not (left_start or right_start)) or consensus_start < 0:
        c.aln_len_cons = 0
        return
    if left_start:
        cons_pos = consensus_start + np.arange(tlen)
    else:
        cons_pos = 3 * query_len - (tlen + consensus_start) + np.arange(tlen)
    in_range = (cons_pos >= 0) & (cons_pos < 3 * query_len)
    cons = np.zeros(tlen, dtype=np.uint8)
    cons[in_range] = consensus[cons_pos[in_range]]
    use = (cons != ord("N")) & (target != ord("N")) & in_range
    total = int(use.sum())
    c.aln_len_cons = total
    if total == 0:
        return
    c.seq_id = float(np.float32((cons[use] == target[use]).sum())
                     / np.float32(total))
    c.ry_seq_id = float(np.float32(
        (CHAR_TO_RY[cons[use]] == CHAR_TO_RY[target[use]]).sum())
        / np.float32(total))


def _deam_matches(aln_len: int, score_aln: float, match_lik: float) -> float:
    """deamMatches posterior, bit-exact to the reference
    (nuclassembleUtil.cpp:1011-1047): DOUBLE arithmetic throughout with
    the reference's f32 sub-expressions — `3.0f * res.alnLength` is a
    float product and `+ 0.9f` adds double(0.9f); everything else is f64.
    (The previous version collapsed the whole chain to f32 under NEP50
    weak-scalar promotion, which flipped one Beta-queue pick in 5M reads.)
    """
    log_adj = math.log(1.4e-9)
    max_length = 100000

    def log_power(length):
        return log_adj - 3.0 * math.log(length)

    log_min = log_power(10)
    log_max = log_power(max_length)
    log_length = log_power(min(aln_len, max_length))
    fraction = (abs(log_length) - abs(log_max)) / (abs(log_min) - abs(log_max))
    prior_aln = 1.0 - fraction
    a = float(score_aln) + float(np.float32(3.0) * np.float32(aln_len))
    p_match = 0.5 * ((a / 5.0 + float(np.float32(0.9)))
                     / float(aln_len + 1)) + 0.5 * prior_aln
    lik_no_match = 1.0 - p_match
    odds_ratio = lik_no_match / match_lik
    odds = (1.0 - p_match) / p_match
    return 1.0 / (1.0 + odds_ratio * odds)


def _ancient_match_count(c: _Cand, consensus: np.ndarray, query_len: int,
                         target: np.ndarray, deam: np.ndarray) -> float:
    """ancientMatchCount (nuclassembleUtil.cpp:1050-1182); `deam` is the
    strand-appropriate (11,4,4) tensor; only the interior layer [5] is
    used for the dimer likelihoods."""
    mm_cons = int((1.0 - np.float32(c.seq_id)) * np.float32(c.aln_len_cons)
                  + np.float32(0.5))
    m_cons = c.aln_len_cons - mm_cons
    score_aln = m_cons * 2 - mm_cons * 3
    if score_aln < 0:
        score_aln += 1 << 32  # unsigned int arithmetic in the reference

    tlen = c.tlen
    right_start = c.tstart == 0 and c.qend == query_len - 1
    left_start = c.qstart == 0 and c.tend == tlen - 1
    offset = tlen - c.aln_len
    consensus_start = query_len - offset
    m_ct = 0.0
    m_ga = 0.0
    if (left_start or right_start) and consensus_start >= 0:
        if left_start:
            cons_pos = consensus_start + np.arange(tlen)
        else:
            cons_pos = 3 * query_len - (tlen + consensus_start) + np.arange(tlen)
        in_range = (cons_pos >= 0) & (cons_pos < 3 * query_len)
        cons = np.zeros(tlen, dtype=np.uint8)
        cons[in_range] = consensus[cons_pos[in_range]]
        use = (cons != ord("N")) & (target != ord("N")) & in_range
        qb = CHAR_TO_ACGT[cons[use]].astype(np.int64)
        tb = CHAR_TO_ACGT[target[use]].astype(np.int64)
        lik = deam[5][qb, tb]
        ct = (qb == 1) & (tb == 3) & (lik > 0)
        ga = (qb == 2) & (tb == 0) & (lik > 0)
        # the reference accumulates into FLOAT mCT/mGA: each double
        # posterior is added in double then rounded to f32
        m_ct = np.float32(0.0)
        m_ga = np.float32(0.0)
        for m in np.nonzero(ct)[0]:
            m_ct = np.float32(float(m_ct) + _deam_matches(
                c.aln_len, float(score_aln), float(lik[m])))
        for m in np.nonzero(ga)[0]:
            m_ga = np.float32(float(m_ga) + _deam_matches(
                c.aln_len, float(score_aln), float(lik[m])))
    base = (np.float32(score_aln) + np.float32(3.0)
            * np.float32(c.aln_len_cons)) / np.float32(5.0)
    return float((base + np.float32(m_ct)) + np.float32(m_ga))


def _native_greedy_contigs(seqdb, aln, pre, iter_ids, qi_arr, cand_rows,
                           cand_ptr, merge_seq_id_thr, ry_seq_id_thr,
                           max_seq_len):
    """Native greedy merge rounds (native/greedy.cpp, Beta-posterior
    queue); returns the `replaced` dict (the Python per-query loop below
    is the oracle, selected with CARPEDEAM_GREEDY_NATIVE=0)."""
    from .. import native
    from .read_assembly import _flatten_ranges

    qi = qi_arr[iter_ids]
    row_ptr, flat = _flatten_ranges(cand_ptr[qi], cand_ptr[qi + 1])
    row_idx = cand_rows[flat]
    tid_all = seqdb.lookup_keys(aln.cols["tkey"]).astype(np.int64)
    rows = {
        "tid": tid_all[row_idx],
        "tkey": aln.cols["tkey"][row_idx].astype(np.uint32),
        "qs": pre["qs"][row_idx].astype(np.int32),
        "qe": pre["qe"][row_idx].astype(np.int32),
        "ts": pre["ts"][row_idx].astype(np.int32),
        "te": pre["te"][row_idx].astype(np.int32),
        "tl": aln.cols["dblen"][row_idx].astype(np.int32),
        "alen": aln.aln_len[row_idx].astype(np.int32),
        "seq_id": pre["seq_id"][row_idx].astype(np.float64),
        "ry": pre["ry_seq_id"][row_idx].astype(np.float64),
        "deam": pre["deam_match"][row_idx].astype(np.float64),
        "alc": pre["aln_len_cons"][row_idx].astype(np.int64),
        "is_rev": pre["is_rev"][row_idx].astype(np.uint8),
        "qok": pre["queue_ok"][row_idx].astype(np.uint8),
    }
    out = native.greedy_contig_rounds(
        seqdb, iter_ids.astype(np.int64), row_ptr, rows,
        merge_seq_id_thr, ry_seq_id_thr, max_seq_len)
    arena, arena_off, out_len = out
    hit = np.nonzero(out_len > 0)[0]
    return {int(iter_ids[j]): arena[arena_off[j]:arena_off[j]
                                    + out_len[j]].tobytes() for j in hit}


def contig_merge(seqdb: SeqDB, aln: AlnDB, damage: DamageModel,
                 merge_seq_id_thr: float, ry_seq_id_thr: float,
                 max_seq_len: int, unsafe: bool = False,
                 min_cov_safe: int = 5) -> SeqDB:
    from .consensus import consensus_caller

    key2id = seqdb.key_to_id()
    aln_by_key = {int(k): i for i, k in enumerate(aln.qkeys)}
    aln_len_all = aln.aln_len

    # safe mode: canonicalisation, identities, consensus update and
    # ancientMatchCount batched over all records (ops/extension_batch)
    pre = None
    if not unsafe:
        from ..ops.extension_batch import batch_contig_scoring
        pre = batch_contig_scoring(seqdb, aln, damage, merge_seq_id_thr,
                                   ry_seq_id_thr)

    out_seqs: list[bytes] = []
    out_ext: list[bool] = []

    # pre mode iterates ONLY queries owning a surviving candidate (the
    # reference's early `candidates.empty()` exits, paid once vectorised);
    # untouched records splice back with whole-range memcpys.
    replaced: dict[int, bytes] = {}
    if pre is not None:
        from .read_assembly import splice_replaced
        cand_rows = np.nonzero(pre["cand"])[0]
        cand_ptr = np.searchsorted(cand_rows, aln.starts)
        n_aln = len(aln.qkeys)
        amap = np.full((int(aln.qkeys.max()) + 1 if n_aln else 1),
                       -1, dtype=np.int64)
        if n_aln:
            amap[aln.qkeys.astype(np.int64)] = np.arange(n_aln)
        keys64 = seqdb.keys.astype(np.int64)
        qi_arr = np.where(keys64 < len(amap),
                          amap[np.minimum(keys64, len(amap) - 1)], -1)
        ncand = np.zeros(len(seqdb), dtype=np.int64)
        v = qi_arr >= 0
        ncand[v] = cand_ptr[qi_arr[v] + 1] - cand_ptr[qi_arr[v]]
        iter_ids = np.nonzero(ncand > 0)[0]
        import os as _os
        if len(iter_ids) \
                and _os.environ.get("CARPEDEAM_GREEDY_NATIVE", "1") != "0":
            return splice_replaced(seqdb, _native_greedy_contigs(
                seqdb, aln, pre, iter_ids, qi_arr, cand_rows, cand_ptr,
                merge_seq_id_thr, ry_seq_id_thr, max_seq_len))
    else:
        iter_ids = range(len(seqdb))

    for i in iter_ids:
        qkey = int(seqdb.keys[i])
        qseq = np.array(seqdb.seq_bytes(i), dtype=np.uint8)
        L = int(seqdb.lengths[i])
        qi = int(qi_arr[i]) if pre is not None else aln_by_key.get(qkey)
        sl = aln.records_for(qi) if qi is not None else slice(0, 0)

        if pre is not None:
            # ---- batched fast path (Python oracle for the native
            # engine; same records, same order) ---------------------------
            cands = []
            tgt_bytes = {}
            queue = CppPriorityQueue(_beta_less)
            for r in cand_rows[cand_ptr[qi]:cand_ptr[qi + 1]]:
                tkey = int(aln.cols["tkey"][r])
                is_rev = bool(pre["is_rev"][r])
                c = _Cand(tkey, int(pre["qs"][r]), int(pre["qe"][r]), L,
                          int(pre["ts"][r]), int(pre["te"][r]),
                          int(aln.cols["dblen"][r]), int(aln_len_all[r]),
                          is_rev)
                c.seq_id = float(pre["seq_id"][r])
                c.ry_seq_id = float(pre["ry_seq_id"][r])
                c.aln_len_cons = int(pre["aln_len_cons"][r])
                tb = np.array(seqdb.seq_bytes(key2id[tkey]), dtype=np.uint8)
                if is_rev:
                    tb = CHAR_REVCOMP[tb][::-1]
                cands.append(c)
                tgt_bytes[(tkey, is_rev)] = tb
                if pre["queue_ok"][r]:
                    c.deam_match = float(pre["deam_match"][r])
                    queue.push(c)
            if not cands:
                continue
            query = qseq.copy()
            qlen_cur = L
        else:
            # ---- canonicalise + seqId/ry vs sequences -------------------
            cands = []
            tgt_bytes = {}
            for r in range(sl.start, sl.stop):
                qs = int(aln.cols["qstart"][r]); qe = int(aln.cols["qend"][r])
                ts = int(aln.cols["dbstart"][r]); te = int(aln.cols["dbend"][r])
                tl = int(aln.cols["dblen"][r])
                a = int(aln_len_all[r])
                tkey = int(aln.cols["tkey"][r])
                tid = key2id[tkey]
                is_rev = qs > qe
                if is_rev:
                    qs, qe = qe, qs
                    ts, te = tl - te - 1, tl - ts - 1
                tb = np.array(seqdb.seq_bytes(tid), dtype=np.uint8)
                if is_rev:
                    tb = CHAR_REVCOMP[tb][::-1]
                c = _Cand(tkey, qs, qe, L, ts, te, tl, a, is_rev)
                qw = qseq[qs:qe + 1]
                tw = tb[ts:ts + (qe - qs + 1)]
                c.seq_id = float(np.float32((qw == tw).sum()) / np.float32(a))
                c.ry_seq_id = float(np.float32(
                    (CHAR_TO_RY[qw] == CHAR_TO_RY[tw]).sum()) / np.float32(a))
                if c.seq_id >= np.float32(merge_seq_id_thr) \
                        and c.ry_seq_id >= np.float32(ry_seq_id_thr) \
                        and qkey != tkey:
                    cands.append(c)
                    tgt_bytes[(tkey, is_rev)] = tb

            if not cands:
                out_seqs.append(qseq.tobytes())
                out_ext.append(bool(seqdb.ext[i]))
                continue

            query = qseq.copy()
            qlen_cur = L
            consensus = consensus_caller(
                cands, lambda c_: tgt_bytes[(c_.tkey, c_.is_rev)], query,
                qlen_cur, unsafe, min_cov_safe)
            for c in cands:
                _update_vs_consensus(c, consensus, qlen_cur,
                                     tgt_bytes[(c.tkey, c.is_rev)])

            queue = CppPriorityQueue(_beta_less)
            for c in cands:
                min_aln_len = 500
                if c.aln_len < 500:
                    min_aln_len = min(500, int(0.2 * c.tlen))
                if c.seq_id >= np.float32(merge_seq_id_thr) \
                        and c.ry_seq_id >= np.float32(ry_seq_id_thr) \
                        and c.aln_len >= min_aln_len:
                    deam = damage.rev if c.is_rev else damage.fwd
                    c.deam_match = _ancient_match_count(
                        c, consensus, qlen_cur,
                        tgt_bytes[(c.tkey, c.is_rev)], deam)
                    queue.push(c)

        could_extend = False
        broke_on_maxlen = False
        while not queue.empty() and not broke_on_maxlen:
            left_off = 0
            right_off = 0
            deferred: list[_Cand] = []
            while not queue.empty():
                best = None
                while not queue.empty():
                    c = queue.pop()
                    rs = c.tstart == 0 and c.tend != c.tlen - 1
                    ls = c.qstart == 0 and c.qend != c.qlen - 1
                    if (rs or ls) and not (c.tstart == 0 and c.qstart == 0) \
                            and c.tkey != qkey:
                        best = c
                        break
                if best is None:
                    break
                tlen = best.tlen
                if best.tstart == 0:
                    if (tlen - (best.tend + 1)) <= right_off:
                        continue
                elif best.qstart == 0:
                    if best.tstart <= left_off:
                        continue
                tb = tgt_bytes[(best.tkey, best.is_rev)]
                if best.tstart == 0 and best.qend == qlen_cur - 1:
                    if right_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = tlen - (best.tend + 1)
                    if len(query) + frag_len >= max_seq_len:
                        broke_on_maxlen = not queue.empty()
                        break
                    query = np.concatenate([query, tb[best.tend + 1:]])
                    right_off += frag_len
                elif best.qstart == 0 and best.tend == tlen - 1:
                    if left_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = best.tstart
                    if len(query) + frag_len >= max_seq_len:
                        broke_on_maxlen = not queue.empty()
                        break
                    query = np.concatenate([tb[:best.tstart], query])
                    left_off += frag_len

            if left_off > 0 or right_off > 0:
                could_extend = True
            if broke_on_maxlen:
                break
            qlen_cur = len(query)

            for c in deferred:
                diag = (c.qstart + left_off) - c.tstart
                tb = tgt_bytes[(c.tkey, c.is_rev)]
                score, start, end, dlen, dist = _ungapped_realign(query, tb,
                                                                  diag)
                if diag >= 0:
                    c.qstart, c.qend = start + dist, end + dist
                    c.tstart, c.tend = start, end
                else:
                    c.qstart, c.qend = start, end
                    c.tstart, c.tend = start + dist, end + dist
                id_cnt = 0
                if c.qend > c.qstart:
                    qw = query[c.qstart:c.qend]
                    tw = tb[c.tstart:c.tstart + (c.qend - c.qstart)]
                    id_cnt = int((qw == tw).sum())
                denom = np.float32(c.qend) - np.float32(c.qstart)
                c.seq_id = float(np.float32(id_cnt) / denom) if denom else 0.0
                c.qlen = qlen_cur
                c.aln_len = dlen
                # getRYSeqId over the (possibly junk) realigned window
                a2 = c.aln_len
                qw = query[c.qstart:c.qstart + a2]
                tw = tb[c.tstart:c.tstart + a2]
                n2 = min(len(qw), len(tw))
                if a2 > 0 and n2 == a2:
                    c.ry_seq_id = float(np.float32(
                        (CHAR_TO_RY[qw] == CHAR_TO_RY[tw]).sum())
                        / np.float32(a2))
                else:
                    c.ry_seq_id = 0.0
                # refill: deamMatch / alnLengthCons intentionally stale
                # (the recompute is commented out in the reference, :429-431)
                if c.seq_id >= np.float32(merge_seq_id_thr) \
                        and c.ry_seq_id >= np.float32(ry_seq_id_thr):
                    queue.push(c)

        if pre is not None:
            if could_extend:
                replaced[i] = query.tobytes()
        elif could_extend:
            out_seqs.append(query.tobytes())
            out_ext.append(True)
        else:
            out_seqs.append(qseq.tobytes())
            out_ext.append(bool(seqdb.ext[i]))

    if pre is not None:
        from .read_assembly import splice_replaced
        return splice_replaced(seqdb, replaced)
    return SeqDB.from_sequences(out_seqs, keys=seqdb.keys.copy(),
                                ext=np.array(out_ext, dtype=bool),
                                headers=seqdb.headers)
