"""ancient_read_assemble: damage-aware greedy extension with reads.

Re-design of src/assembler/ancientReadsResults.cpp (doNuclAssembly1).
Per query: candidate overlaps are filtered (forward-strand, terminal,
non-contig, seqId/rySeqId thresholds), scored with the damage likelihood
against the safe-mode consensus (== the corrected query), and greedily
spliced left/right; leftover candidates are re-aligned against the grown
query by diagonal and re-scored until the queue drains.

Faithfully replicated reference details:
* the initial right/left-terminal test runs on RAW (pre-canonicalisation)
  coordinates, so reverse-strand hits (qStart > qEnd) never participate in
  read-phase extension (:202-213) — forward-only by construction.
* safe mode (default): consensus = query copied into the middle third of a
  3L 'N' buffer (consensusCaller early-return, nuclassembleUtil.cpp:586-592).
* seqId is recomputed three times with different denominators: vs query
  (alnLength, :282-293), vs consensus (non-N column count, :423-461), and
  after re-alignment with qEnd EXCLUSIVE (updateNuclAlignment,
  nuclassembleUtil.cpp:28-32).
* queue ordered by sLenNorm with std::priority_queue tie semantics
  (CppPriorityQueue); candidates enter only if sRatio > likelihood
  threshold; re-queued candidates skip the rySeqId check (:521).
* extension is blocked per side once that side grew this round; deferred
  candidates are re-aligned on diagonal (qStart + leftOffset - dbStart).
"""
from __future__ import annotations

import os

import numpy as np

from ..aligndb import AlnDB
from ..constants import CHAR_REVCOMP, CHAR_TO_ACGT, CHAR_TO_RY
from ..damage import DamageModel, seq_error_profile_ld
from ..io.seqdb import SeqDB
from ..ops.likelihood import (CppPriorityQueue, calc_likelihood_consensus,
                              likelihood_table, logf32)


class _Cand:
    """Mutable candidate record (Matcher::result_t subset)."""
    __slots__ = ("tkey", "qstart", "qend", "qlen", "tstart", "tend", "tlen",
                 "aln_len", "seq_id", "ry_seq_id", "is_rev", "s_len_norm",
                 "s_ratio")

    def __init__(self, tkey, qstart, qend, qlen, tstart, tend, tlen, aln_len):
        self.tkey = tkey
        self.qstart, self.qend, self.qlen = qstart, qend, qlen
        self.tstart, self.tend, self.tlen = tstart, tend, tlen
        self.aln_len = aln_len
        self.seq_id = 0.0
        self.ry_seq_id = 0.0
        self.is_rev = False
        self.s_len_norm = 0.0
        self.s_ratio = 0.0


def _seq_id_vs_consensus(cand: _Cand, consensus: np.ndarray, query_len: int,
                         target: np.ndarray):
    """updateSeqIdConsensusReads for one candidate: (seqId, rySeqId,
    totalCnt, side) where side is 'L', 'R' or None."""
    tlen = cand.tlen
    right_start = cand.tstart == 0 and cand.qend == query_len - 1
    left_start = cand.qstart == 0 and cand.tend == tlen - 1
    offset = tlen - cand.aln_len
    consensus_start = query_len - offset
    if (not (left_start or right_start)) or consensus_start < 0:
        return cand.seq_id, cand.ry_seq_id, 0, None
    if left_start:
        cons_pos = consensus_start + np.arange(tlen)
    else:
        cons_pos = 3 * query_len - (tlen + consensus_start) + np.arange(tlen)
    in_range = (cons_pos >= 0) & (cons_pos < 3 * query_len)
    cons = np.zeros(tlen, dtype=np.uint8)
    cons[in_range] = consensus[cons_pos[in_range]]
    use = (cons != ord("N")) & (target != ord("N")) & in_range
    total = int(use.sum())
    if total == 0:
        return cand.seq_id, cand.ry_seq_id, 0, ("L" if left_start else "R")
    id_cnt = int((cons[use] == target[use]).sum())
    ry_cnt = int((CHAR_TO_RY[cons[use]] == CHAR_TO_RY[target[use]]).sum())
    seq_id = np.float32(id_cnt) / np.float32(total)
    ry_id = np.float32(ry_cnt) / np.float32(total)
    return float(seq_id), float(ry_id), total, ("L" if left_start else "R")


def _ungapped_realign(query: np.ndarray, target: np.ndarray, diag: int):
    """DistanceCalculator::ungappedAlignmentByDiagonal, mode END_TO_END:
    returns (score, start, end, diagonal_len, dist) or zeros if invalid."""
    qlen, tlen = len(query), len(target)
    dist = abs(diag)
    if diag >= 0 and dist < qlen:
        n = min(tlen, qlen - dist)
        qw, tw = query[dist:dist + n], target[:n]
    elif diag < 0 and dist < tlen:
        n = min(tlen - dist, qlen)
        qw, tw = query[:n], target[dist:dist + n]
    else:
        return 0, -1, -1, 0, dist
    qc = CHAR_TO_ACGT[qw]
    tc = CHAR_TO_ACGT[tw]
    # scoring uses the 5-letter fold: match +2 only for equal ACGT codes
    from ..constants import CHAR_TO_CODE
    q5, t5 = CHAR_TO_CODE[qw], CHAR_TO_CODE[tw]
    m = int(((q5 == t5) & (q5 < 4)).sum())
    score = max(2 * m - 3 * (n - m), 0)
    return score, 0, n - 1, n, dist


def _flatten_ranges(starts, ends):
    """Vectorised concatenation of [starts[j], ends[j]) index ranges."""
    cnt = ends - starts
    ptr = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    total = int(ptr[-1])
    idx = np.repeat(starts - ptr[:-1], cnt) + np.arange(total,
                                                        dtype=np.int64)
    return ptr, idx


def _native_greedy_reads(seqdb, aln, pre, iter_ids, qi_arr, cand_rows,
                         cand_ptr, logm_fwd, seq_id_thr, likelihood_thr,
                         rand_aln_penal, excess_penal, max_seq_len):
    """Run the greedy splice rounds in native C++ (native/greedy.cpp).
    Returns the `replaced` dict (the Python per-query loop below is the
    oracle, selected with CARPEDEAM_GREEDY_NATIVE=0)."""
    from .. import native

    qi = qi_arr[iter_ids]
    row_ptr, flat = _flatten_ranges(cand_ptr[qi], cand_ptr[qi + 1])
    row_idx = cand_rows[flat]
    tid_all = seqdb.lookup_keys(aln.cols["tkey"]).astype(np.int64)
    rows = {
        "tid": tid_all[row_idx],
        "tkey": aln.cols["tkey"][row_idx].astype(np.uint32),
        "qs": aln.cols["qstart"][row_idx].astype(np.int32),
        "qe": aln.cols["qend"][row_idx].astype(np.int32),
        "ts": aln.cols["dbstart"][row_idx].astype(np.int32),
        "te": aln.cols["dbend"][row_idx].astype(np.int32),
        "tl": aln.cols["dblen"][row_idx].astype(np.int32),
        "alen": aln.aln_len[row_idx].astype(np.int32),
        "seq_id": pre["seq_id"][row_idx].astype(np.float64),
        "ry": pre["ry_seq_id"][row_idx].astype(np.float64),
        "sln": pre["s_len_norm"][row_idx].astype(np.float64),
        "sratio": pre["s_ratio"][row_idx].astype(np.float64),
        "qok": pre["queue_ok"][row_idx].astype(np.uint8),
    }
    out = native.greedy_read_rounds(
        seqdb, iter_ids.astype(np.int64), row_ptr, rows,
        pre["max_left"][iter_ids].astype(np.int64),
        pre["max_right"][iter_ids].astype(np.int64),
        np.ascontiguousarray(logm_fwd, dtype=np.float64),
        seq_id_thr, likelihood_thr, float(logf32(rand_aln_penal)),
        float(logf32(excess_penal)), max_seq_len)
    arena, arena_off, out_len = out
    hit = np.nonzero(out_len > 0)[0]
    return {int(iter_ids[j]): arena[arena_off[j]:arena_off[j]
                                    + out_len[j]].tobytes() for j in hit}


def read_assembly(seqdb: SeqDB, aln: AlnDB, damage: DamageModel,
                  seq_id_thr: float, ry_seq_id_thr: float,
                  likelihood_thr: float, rand_aln_penal: float,
                  excess_penal: float, max_seq_len: int,
                  unsafe: bool = False, min_cov_safe: int = 5,
                  planes=None, lengths=None, prologue=None) -> SeqDB:
    """One iteration of read-phase extension over the whole (corrected) DB."""
    from ..utils import subtimer
    from .consensus import consensus_caller

    key2id = seqdb.key_to_id()
    seq_err = seq_error_profile_ld(0.001)  # doNuclAssembly1 uses 0.001 (:172)
    fwd = damage.fwd_ld if damage.fwd_ld is not None else damage.fwd
    rev = damage.rev_ld if damage.rev_ld is not None else damage.rev
    logm_fwd = likelihood_table(fwd, seq_err)
    logm_rev = likelihood_table(rev, seq_err)
    aln_by_key = {int(k): i for i, k in enumerate(aln.qkeys)}
    aln_len_all = aln.aln_len

    # safe mode: passes A-C + consensus seqId + likelihood batched over
    # every record at once (ops/extension_batch); the loop below then only
    # materialises candidates and runs the greedy splicing rounds
    pre = None
    if not unsafe:
        from ..ops.extension_batch import batch_initial_scoring
        with subtimer("ext.batch_scoring"):
            pre = batch_initial_scoring(seqdb, aln, damage, seq_id_thr,
                                        ry_seq_id_thr, likelihood_thr,
                                        rand_aln_penal, excess_penal,
                                        planes=planes, lengths=lengths,
                                        prologue=prologue)

    out_seqs: list[bytes] = []
    out_ext: list[bool] = []

    # per-query candidate row lists (skip-fast plumbing): queries whose
    # alignment group holds no surviving candidate pass through without
    # touching the per-query machinery below — at scale the bulk of
    # queries at every iteration (the reference pays the same fast path
    # via its early `candidates.empty()` exits)
    if pre is not None:
        cand_rows = np.nonzero(pre["cand"])[0]
        cand_ptr = np.searchsorted(cand_rows, aln.starts)
        tkey_a = np.ascontiguousarray(aln.cols["tkey"])
        qs_a = np.ascontiguousarray(aln.cols["qstart"])
        qe_a = np.ascontiguousarray(aln.cols["qend"])
        ts_a = np.ascontiguousarray(aln.cols["dbstart"])
        te_a = np.ascontiguousarray(aln.cols["dbend"])
        tl_a = np.ascontiguousarray(aln.cols["dblen"])
    ext_flags = seqdb.ext
    data_flat = seqdb.data
    offsets_all = seqdb.offsets
    lengths_all = seqdb.lengths

    # batched mode iterates ONLY queries whose alignment group holds a
    # surviving candidate (the reference's early `candidates.empty()`
    # exits, paid once vectorised instead of 120k times in Python);
    # untouched records are spliced back with whole-range memcpys below.
    replaced: dict[int, bytes] = {}
    if pre is not None:
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
    else:
        iter_ids = range(len(seqdb))

    _st_greedy = subtimer("ext.greedy_loop")
    _st_greedy.__enter__()
    if pre is not None and len(iter_ids) \
            and os.environ.get("CARPEDEAM_GREEDY_NATIVE", "1") != "0":
        replaced = _native_greedy_reads(seqdb, aln, pre, iter_ids, qi_arr,
                                        cand_rows, cand_ptr, logm_fwd,
                                        seq_id_thr, likelihood_thr,
                                        rand_aln_penal, excess_penal,
                                        max_seq_len)
        iter_ids = np.zeros(0, dtype=np.int64)
    for i in iter_ids:
        qkey = int(seqdb.keys[i])
        qi = int(qi_arr[i]) if pre is not None else aln_by_key.get(qkey)

        if pre is not None:
            # ---- batched fast path: candidates + scores precomputed ----
            L = int(lengths_all[i])
            qseq = np.array(seqdb.seq_bytes(i), dtype=np.uint8)
            cands = []
            queue = CppPriorityQueue(lambda a_, b_: a_.s_len_norm
                                     < b_.s_len_norm)
            tgt_bytes = {}
            for r in cand_rows[cand_ptr[qi]:cand_ptr[qi + 1]]:
                c = _Cand(int(tkey_a[r]), int(qs_a[r]), int(qe_a[r]), L,
                          int(ts_a[r]), int(te_a[r]), int(tl_a[r]),
                          int(aln_len_all[r]))
                c.seq_id = float(pre["seq_id"][r])
                c.ry_seq_id = float(pre["ry_seq_id"][r])
                cands.append(c)
                tgt_bytes[c.tkey] = np.array(
                    seqdb.seq_bytes(key2id[c.tkey]), dtype=np.uint8)
                if pre["queue_ok"][r]:
                    c.s_len_norm = float(pre["s_len_norm"][r])
                    c.s_ratio = float(pre["s_ratio"][r])
                    queue.push(c)
            query = qseq.copy()
            qlen_cur = L
            max_left = int(pre["max_left"][i])
            max_right = int(pre["max_right"][i])
            consensus = consensus_caller(cands,
                                         lambda c_: tgt_bytes[c_.tkey],
                                         query, qlen_cur, False,
                                         min_cov_safe)
        else:
            qseq = np.array(seqdb.seq_bytes(i), dtype=np.uint8)
            L = int(lengths_all[i])
            sl = aln.records_for(qi) if qi is not None else slice(0, 0)
            # ---- pass A-C: forward terminal overlaps -> candidates ------
            cands = []
            for r in range(sl.start, sl.stop):
                qs = int(aln.cols["qstart"][r]); qe = int(aln.cols["qend"][r])
                ts = int(aln.cols["dbstart"][r]); te = int(aln.cols["dbend"][r])
                tl = int(aln.cols["dblen"][r])
                a = int(aln_len_all[r])
                right_start = ts == 0 and qe == L - 1
                left_start = qs == 0 and te == tl - 1
                if not (right_start or left_start):
                    continue  # raw-coordinate test: drops all reverse hits
                tkey = int(aln.cols["tkey"][r])
                tid = key2id[tkey]
                if tid == qkey:
                    # identity (id == key in dense DBs)
                    continue
                c = _Cand(tkey, qs, qe, L, ts, te, tl, a)
                # pass B: seqId / rySeqId vs corrected sequences
                tb = seqdb.seq_bytes(tid)
                qw = qseq[qs:qe + 1]
                tw = tb[ts:ts + (qe - qs + 1)]
                c.seq_id = float(np.float32((qw == tw).sum()) / np.float32(a))
                c.ry_seq_id = float(np.float32(
                    (CHAR_TO_RY[qw] == CHAR_TO_RY[tw]).sum()) / np.float32(a))
                # pass C: notContig filter
                no_offset = (tl - a) == 0
                if seqdb.ext[tid] or a < 30 or c.seq_id < np.float32(seq_id_thr) \
                        or no_offset:
                    continue
                cands.append(c)

            if not cands:
                out_seqs.append(qseq.tobytes())
                out_ext.append(bool(seqdb.ext[i]))
                continue

            # ---- consensus + seqId update + likelihood ----------------------
            query = qseq.copy()
            qlen_cur = L
            max_left = 0
            max_right = 0
            tgt_bytes = {}
            for c in cands:
                tgt_bytes[c.tkey] = np.array(seqdb.seq_bytes(key2id[c.tkey]),
                                             dtype=np.uint8)
            consensus = consensus_caller(cands, lambda c_: tgt_bytes[c_.tkey],
                                         query, qlen_cur, unsafe, min_cov_safe)
            for c in cands:
                tb = tgt_bytes[c.tkey]
                sid, ryid, total, side = _seq_id_vs_consensus(c, consensus,
                                                              qlen_cur, tb)
                c.seq_id, c.ry_seq_id = sid, ryid
                if side == "L" and total > max_left:
                    max_left = total
                elif side == "R" and total > max_right:
                    max_right = total

            queue = CppPriorityQueue(lambda a_, b_: a_.s_len_norm < b_.s_len_norm)
            for c in cands:
                not_inside = c.tlen != c.aln_len
                right_start = c.tstart == 0
                left_start = c.qstart == 0
                if not ((right_start or left_start) and not_inside
                        and c.tkey != qkey
                        and c.ry_seq_id >= np.float32(ry_seq_id_thr)
                        and c.seq_id >= np.float32(seq_id_thr)):
                    continue
                max_aln = max_left if (c.qstart == 0 and c.tend == c.tlen - 1) \
                    else max_right
                logm = logm_rev if c.is_rev else logm_fwd
                c.s_len_norm, c.s_ratio = calc_likelihood_consensus(
                    logm, consensus, qlen_cur, tgt_bytes[c.tkey],
                    c.qstart, c.qend, c.tstart, c.tend, c.aln_len, max_aln,
                    rand_aln_penal, excess_penal)
                if c.s_ratio > likelihood_thr:
                    queue.push(c)

        # ---- greedy extension rounds ------------------------------------
        could_extend = False
        broke_on_maxlen = False
        while not queue.empty() and not broke_on_maxlen:
            left_off = 0
            right_off = 0
            deferred: list[_Cand] = []
            while not queue.empty():
                # selectNuclFragmentToExtendReads
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
                if best.tstart == 0 and best.qend == qlen_cur - 1:
                    if right_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = tlen - (best.tend + 1)
                    if len(query) + frag_len >= max_seq_len:
                        broke_on_maxlen = not queue.empty()
                        break
                    frag = tgt_bytes[best.tkey][best.tend + 1:]
                    query = np.concatenate([query, frag])
                    right_off += frag_len
                elif best.qstart == 0 and best.tend == tlen - 1:
                    if left_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = best.tstart
                    if len(query) + frag_len >= max_seq_len:
                        broke_on_maxlen = not queue.empty()
                        break
                    frag = tgt_bytes[best.tkey][:best.tstart]
                    query = np.concatenate([frag, query])
                    left_off += frag_len

            if left_off > 0 or right_off > 0:
                could_extend = True
            if broke_on_maxlen:
                break
            qlen_cur = len(query)

            # re-align deferred candidates against the grown query
            for c in deferred:
                diag = (c.qstart + left_off) - c.tstart
                tb = tgt_bytes[c.tkey]
                score, start, end, dlen, dist = _ungapped_realign(query, tb,
                                                                  diag)
                # updateNuclAlignment (nuclassembleUtil.cpp:9-47)
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

            consensus = consensus_caller(deferred,
                                         lambda c_: tgt_bytes[c_.tkey],
                                         query, qlen_cur, unsafe,
                                         min_cov_safe)
            for c in deferred:
                sid, ryid, total, side = _seq_id_vs_consensus(
                    c, consensus, qlen_cur, tgt_bytes[c.tkey])
                c.seq_id, c.ry_seq_id = sid, ryid
                if side == "L" and total > max_left:
                    max_left = total
                elif side == "R" and total > max_right:
                    max_right = total

            for c in deferred:
                not_inside = c.tlen != c.aln_len
                rs = c.tstart == 0
                ls = c.qstart == 0
                if c.seq_id >= np.float32(seq_id_thr) and (rs or ls) \
                        and c.tkey != qkey and not_inside:
                    max_aln = max_left if (c.qstart == 0
                                           and c.tend == c.tlen - 1) \
                        else max_right
                    logm = logm_rev if c.is_rev else logm_fwd
                    c.s_len_norm, c.s_ratio = calc_likelihood_consensus(
                        logm, consensus, qlen_cur, tgt_bytes[c.tkey],
                        c.qstart, c.qend, c.tstart, c.tend, c.aln_len,
                        max_aln, rand_aln_penal, excess_penal)
                    if c.s_ratio > likelihood_thr:
                        queue.push(c)

        if pre is not None:
            if could_extend:
                replaced[i] = query.tobytes()
            continue
        if could_extend:
            out_seqs.append(query.tobytes())
            out_ext.append(True)
        else:
            out_seqs.append(qseq.tobytes())
            out_ext.append(bool(seqdb.ext[i]))

    _st_greedy.__exit__()
    if pre is None:
        return SeqDB.from_sequences(out_seqs, keys=seqdb.keys.copy(),
                                    ext=np.array(out_ext, dtype=bool),
                                    headers=seqdb.headers)
    return splice_replaced(seqdb, replaced)


def splice_replaced(seqdb: SeqDB, replaced: dict[int, bytes]) -> SeqDB:
    """Build the output DB by splicing the extended records into the
    input CSR store (untouched records copy through in whole-range
    memcpys; `replaced` rows get new bytes and ext=True)."""
    n = len(seqdb)
    offsets_all = seqdb.offsets
    lengths_all = seqdb.lengths
    data_flat = seqdb.data
    total_in = int(offsets_all[-1] + lengths_all[-1]) if n else 0
    new_lengths = lengths_all.astype(np.int64).copy()
    new_ext = seqdb.ext.copy()
    parts: list[np.ndarray] = []
    prev = 0  # flat offset of the first byte not yet emitted
    for i in sorted(replaced):
        o = int(offsets_all[i])
        if o > prev:
            parts.append(data_flat[prev:o])
        rec = np.frombuffer(replaced[i], dtype=np.uint8)
        parts.append(rec)
        new_lengths[i] = len(rec)
        new_ext[i] = True
        prev = o + int(lengths_all[i])
    if total_in > prev:
        parts.append(data_flat[prev:total_in])
    new_data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    new_offsets = np.concatenate([[0], np.cumsum(new_lengths[:-1])]) \
        .astype(np.int64) if n else np.zeros(0, np.int64)
    return SeqDB(new_data, new_offsets, new_lengths, seqdb.keys.copy(),
                 new_ext, seqdb.headers, seqdb.dbtype)
