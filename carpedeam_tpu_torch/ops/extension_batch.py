"""Batched initial-pass scoring for read-phase extension (safe mode).

doNuclAssembly1's per-query passes A-C, consensus seqId update and
damage-likelihood scoring (ancientReadsResults.cpp:179-366) touch every
alignment record independently — a dense batched computation.  This
module evaluates them for ALL records of the alignment DB in chunked
(records x Lmax) window operations, so stages/read_assembly.py only runs
the greedy splicing rounds per query.

Safe-mode only: the consensus equals the query in the middle third of
the 3L buffer, which turns the consensus lookups into affine window
gathers (right pad: consensus position 2L - alnLen + i; left pad:
L - offset + i).  Unsafe mode keeps the per-candidate path.

Float semantics mirror the per-candidate oracle: integer window counts
with IEEE f32 divisions, f64 likelihood sums (row-masked; summation
grouping can differ from the compact per-candidate np.sum at the last
ulp — decision margins are far larger, validated bit-exact end-to-end).
"""
from __future__ import annotations

import numpy as np

from ..constants import CHAR_TO_ACGT, CHAR_TO_RY
from ..damage import seq_error_profile_ld
from .likelihood import likelihood_table, logf32, ratio_ld_array

def _chunk_for(max_len: int) -> int:
    """Bound the (chunk, max_len) window working set to ~2^27 elements."""
    return max(256, (1 << 27) // max(max_len, 1))


def _consensus_likelihood_host(seqdb, qid, tid, qs, qe, ts, te, alen,
                               logm, rows, max_len):
    """Safe-mode consensus seqId + damage likelihood for the given record
    indices (NumPy, exact raw-char semantics).  Returns dict of arrays
    indexed like `rows`."""
    data = seqdb.data
    offsets = seqdb.offsets
    ry_flat = CHAR_TO_RY[data]
    acgt_flat = CHAR_TO_ACGT[data]
    not_n_flat = data != ord("N")
    tlen = seqdb.lengths[tid]
    qlen = seqdb.lengths[qid]
    n = len(rows)
    out = {k: np.zeros(n, dtype=np.float64)
           for k in ("seq_id", "ry_seq_id")}
    out["lik_mod"] = np.zeros(n, dtype=np.longdouble)
    out["total"] = np.zeros(n, dtype=np.int64)
    out["aln_count"] = np.zeros(n, dtype=np.int64)
    out["valid"] = np.zeros(n, dtype=bool)
    out["left"] = np.zeros(n, dtype=bool)
    out["has"] = np.zeros(n, dtype=bool)
    pos = np.arange(max_len, dtype=np.int64)[None, :]
    chunk = _chunk_for(max_len)
    for c0 in range(0, n, chunk):
        sub = slice(c0, min(c0 + chunk, n))
        rc = rows[sub]
        qsr, qer, tsr, ter = qs[rc], qe[rc], ts[rc], te[rc]
        alr, tlr, qlr = alen[rc], tlen[rc], qlen[rc]
        qoff, toff = offsets[qid[rc]], offsets[tid[rc]]

        right_c = (tsr == 0) & (qer == qlr - 1)
        left_c = (qsr == 0) & (ter == tlr - 1)
        offs = tlr - alr
        cs_ok = (qlr - offs) >= 0
        valid = (right_c | left_c) & cs_ok
        qpos0 = np.where(left_c, -offs, qlr - alr)
        i_grid = pos
        t_in = i_grid < tlr[:, None]
        qp = qpos0[:, None] + i_grid
        q_in = (qp >= 0) & (qp < qlr[:, None])
        cons_pos = np.where(left_c[:, None], qlr[:, None] - offs[:, None],
                            2 * qlr[:, None] - alr[:, None]) + i_grid
        in_rng = (cons_pos >= 0) & (cons_pos < 3 * qlr[:, None])
        tg_idx = np.clip(toff[:, None] + i_grid, 0, len(data) - 1)
        qg_idx = np.clip(qoff[:, None] + qp, 0, len(data) - 1)
        t_not_n = not_n_flat[tg_idx] & t_in
        use = t_not_n & q_in & in_rng & (not_n_flat[qg_idx])
        total = use.sum(axis=1)
        idc2 = ((data[qg_idx] == data[tg_idx]) & use).sum(axis=1)
        ryc2 = ((ry_flat[qg_idx] == ry_flat[tg_idx]) & use).sum(axis=1)
        out["has"][sub] = total > 0
        out["seq_id"][sub] = (idc2.astype(np.float32)
                              / np.maximum(total, 1).astype(np.float32)) \
            .astype(np.float64)
        out["ry_seq_id"][sub] = (ryc2.astype(np.float32)
                                 / np.maximum(total, 1).astype(np.float32)) \
            .astype(np.float64)
        out["total"][sub] = total
        out["valid"][sub] = valid
        out["left"][sub] = left_c

        t_nn = not_n_flat[tg_idx] & t_in
        t_rank = np.cumsum(t_nn, axis=1) - 1
        lay = np.where(t_rank < 5, np.maximum(t_rank, 0), 5)
        from_end = t_rank - (tlr[:, None] - 5)
        lay = np.where(from_end >= 0, 6 + from_end, lay)
        lay = np.clip(lay, 0, 10)
        use_l = t_nn & q_in & in_rng & not_n_flat[qg_idx]
        qb4 = acgt_flat[qg_idx].astype(np.int64)
        tb4 = acgt_flat[tg_idx].astype(np.int64)
        vals = logm[lay, qb4, tb4]
        out["lik_mod"][sub] = np.where(use_l, vals, 0.0) \
            .astype(np.longdouble).cumsum(axis=1)[:, -1]
        out["aln_count"][sub] = use_l.sum(axis=1)
    return out


def _prologue_arrays(seqdb, aln):
    """Record-indexing arrays for the initial pass, computed from
    metadata that correction preserves (keys, lengths, ext)."""
    qid = seqdb.lookup_keys(aln.qkey).astype(np.int64)
    tid = seqdb.lookup_keys(aln.cols["tkey"]).astype(np.int64)
    qs = aln.cols["qstart"].astype(np.int64)
    qe = aln.cols["qend"].astype(np.int64)
    ts = aln.cols["dbstart"].astype(np.int64)
    te = aln.cols["dbend"].astype(np.int64)
    tlen = seqdb.lengths[tid]
    qlen = seqdb.lengths[qid]
    alen = aln.aln_len.astype(np.int64)
    right_raw = (ts == 0) & (qe == qlen - 1)
    left_raw = (qs == 0) & (te == tlen - 1)
    terminal = (right_raw | left_raw) & (qs <= qe)
    not_identity = tid != aln.qkey.astype(np.int64)
    return {"qid": qid, "tid": tid, "qs": qs, "qe": qe, "ts": ts,
            "te": te, "tlen": tlen, "qlen": qlen, "alen": alen,
            "terminal": terminal, "not_identity": not_identity}


def ext_prologue(seqdb, aln, planes, lengths):
    """Dispatch the extension pass-B window-identity device call against
    the (corrected) planes.  Uses only metadata the correction stage
    preserves, so the pipeline can issue it while the correction output
    is still streaming to the host (the device executes in order: the
    correction kernel, the plane derivation, then this)."""
    n_rec = len(aln.qkey)
    if not n_rec or planes is None or planes["sym"].shape[1] > 16384:
        return None
    from .window_cuda import window_identity_dispatch
    pro = _prologue_arrays(seqdb, aln)
    rt = np.nonzero(pro["terminal"] & pro["not_identity"])[0]
    pro["rt"] = rt
    pro["win_handle"] = None
    if len(rt):
        win = (pro["qe"] - pro["qs"] + 1)[rt]
        pro["win_handle"] = window_identity_dispatch(
            planes, len(seqdb), pro["qid"][rt], pro["tid"][rt],
            np.zeros(len(rt), bool), pro["qs"][rt], pro["ts"][rt], win)
    return pro


def batch_initial_scoring(seqdb, aln, damage, seq_id_thr: float,
                          ry_seq_id_thr: float, likelihood_thr: float,
                          rand_aln_penal: float, excess_penal: float,
                          planes=None, lengths=None,
                          prologue=None) -> dict:
    """Returns per-record arrays (length == len(aln.qkey)):

      cand      pass A-C candidate mask
      seq_id, ry_seq_id   consensus-updated identities (f32-exact)
      queue_ok  entered the priority queue (incl. sRatio > threshold)
      s_len_norm, s_ratio  likelihood scores (f64)
    plus per-query max_left / max_right (length == len(seqdb))."""
    n_rec = len(aln.qkey)
    n_seq = len(seqdb)
    # ---- pass A: raw terminal test (reverse hits have qs > qe and fail;
    # arrays may arrive precomputed from ext_prologue) ---------------------
    pro = prologue if prologue is not None \
        else _prologue_arrays(seqdb, aln)
    qid, tid = pro["qid"], pro["tid"]
    qs, qe, ts, te = pro["qs"], pro["qe"], pro["ts"], pro["te"]
    tlen, qlen, alen = pro["tlen"], pro["qlen"], pro["alen"]
    terminal, not_identity = pro["terminal"], pro["not_identity"]

    max_len = int(seqdb.lengths.max()) if n_seq else 1
    data = seqdb.data
    offsets = seqdb.offsets

    # exact-semantics table (80-bit damage tensors; doNuclAssembly1 uses
    # seq error 0.001, ancientReadsResults.cpp:172) and f32 penalty logs
    # (libgab's `using namespace std` makes log(float) resolve to logf)
    deam_ld = damage.fwd_ld if damage.fwd_ld is not None else damage.fwd
    logm = likelihood_table(deam_ld, seq_error_profile_ld(0.001))
    log_excess = logf32(excess_penal)
    log_rand = logf32(rand_aln_penal)

    def _exact_sln_ratio(lik_ld, aln_count, max_aln):
        """sLenNorm/sRatio with the reference's exact precision chain:
        ld likMod + f32 excess term -> double; ratio via expl."""
        term = (max_aln - aln_count).astype(np.float32) * log_excess
        sln_ld = np.asarray(lik_ld, dtype=np.longdouble) \
            + term.astype(np.longdouble)
        s_len_norm = sln_ld.astype(np.float64)
        rand_aln = (max_aln.astype(np.float32) * log_rand) \
            .astype(np.float64)
        s_ratio = ratio_ld_array(rand_aln, sln_ld)
        return s_len_norm, s_ratio

    def _finish(cand, seq_id, ry_seq_id, side_total, side_is_left,
                side_valid, lik_mod, aln_count):
        max_left = np.zeros(n_seq, dtype=np.int64)
        max_right = np.zeros(n_seq, dtype=np.int64)
        cc = np.nonzero(cand & side_valid)[0]
        lmask = side_is_left[cc]
        np.maximum.at(max_left, qid[cc[lmask]], side_total[cc[lmask]])
        np.maximum.at(max_right, qid[cc[~lmask]], side_total[cc[~lmask]])
        not_inside = tlen != alen
        queue_pre = cand & ((ts == 0) | (qs == 0)) & not_inside \
            & not_identity \
            & (ry_seq_id.astype(np.float32) >= np.float32(ry_seq_id_thr)) \
            & (seq_id.astype(np.float32) >= np.float32(seq_id_thr))
        is_left_like = (qs == 0) & (te == tlen - 1)
        max_aln = np.where(is_left_like, max_left[qid], max_right[qid])
        excess = max_aln - aln_count
        s_len_norm = lik_mod + excess * log_excess
        with np.errstate(over="ignore"):
            s_ratio = 1.0 / (1.0 + np.exp(max_aln * log_rand - s_len_norm))
        queue_ok = queue_pre & (s_ratio > likelihood_thr)
        return {"cand": cand, "seq_id": seq_id, "ry_seq_id": ry_seq_id,
                "queue_ok": queue_ok, "s_len_norm": s_len_norm,
                "s_ratio": s_ratio, "max_left": max_left,
                "max_right": max_right}

    # ---- device path: pass B + consensus + likelihood as CUDA window
    # kernels over the shared sequence planes (records touching non-ACGT
    # sequences recomputed on the host for exact raw-char semantics) ------
    if planes is not None and n_rec \
            and planes["sym"].shape[1] <= 16384:
        from ..utils import subtimer
        from .ext_cuda import consensus_likelihood_cuda
        from .window_cuda import has_non_acgt_flags, window_identity_cuda
        # host recompute for records with non-ACGT chars OR sequences
        # longer than the plane width (their rows are truncated)
        with subtimer("ext.flags"):
            flags = has_non_acgt_flags(seqdb) \
                | (seqdb.lengths.astype(np.int64) > planes["sym"].shape[1])
        seq_id = np.zeros(n_rec, dtype=np.float64)
        ry_seq_id = np.zeros(n_rec, dtype=np.float64)
        rt = pro["rt"] if prologue is not None \
            else np.nonzero(terminal & not_identity)[0]
        if len(rt):
            win = (qe - qs + 1)[rt]
            with subtimer("ext.window_identity_dev"):
                if prologue is not None \
                        and pro.get("win_handle") is not None:
                    from .window_cuda import window_identity_collect
                    idc, ryc = window_identity_collect(*pro["win_handle"])
                else:
                    idc, ryc = window_identity_cuda(
                        planes, n_seq, qid[rt], tid[rt],
                        np.zeros(len(rt), bool), qs[rt], ts[rt], win)
            fx = np.nonzero(flags[qid[rt]] | flags[tid[rt]])[0]
            from ..utils import coverage_add
            coverage_add("extension_scoring", len(rt) - len(fx), len(fx))
            if len(fx):
                idc[fx], ryc[fx] = _pass_b_identity_host(
                    seqdb, qid[rt[fx]], tid[rt[fx]],
                    np.zeros(len(fx), bool), qs[rt[fx]], ts[rt[fx]],
                    win[fx])
            seq_id[rt] = (idc.astype(np.float32)
                          / alen[rt].astype(np.float32)).astype(np.float64)
            ry_seq_id[rt] = (ryc.astype(np.float32)
                             / alen[rt].astype(np.float32)) \
                .astype(np.float64)
        no_offset = (tlen - alen) == 0
        cand = np.zeros(n_rec, dtype=bool)
        cand[rt] = True
        cand &= (~seqdb.ext[tid]) & (alen >= 30) & (~no_offset) \
            & (seq_id.astype(np.float32) >= np.float32(seq_id_thr))

        side_total = np.zeros(n_rec, dtype=np.int64)
        side_is_left = np.zeros(n_rec, dtype=bool)
        side_valid = np.zeros(n_rec, dtype=bool)
        lik_mod = np.zeros(n_rec, dtype=np.float64)
        aln_count = np.zeros(n_rec, dtype=np.int64)
        cc = np.nonzero(cand)[0]
        if len(cc):
            right_c = (ts[cc] == 0) & (qe[cc] == qlen[cc] - 1)
            left_c = (qs[cc] == 0) & (te[cc] == tlen[cc] - 1)
            offs = tlen[cc] - alen[cc]
            valid = (right_c | left_c) & ((qlen[cc] - offs) >= 0)
            qpos0 = np.where(left_c, -offs, qlen[cc] - alen[cc])
            base = np.where(left_c, qlen[cc] - offs,
                            2 * qlen[cc] - alen[cc])
            ir0 = -base
            ir1 = 3 * qlen[cc] - base
            with subtimer("ext.consensus_lik_dev"):
                total, idc2, ryc2, lik = consensus_likelihood_cuda(
                    planes, n_seq, qid[cc], tid[cc], qpos0, qlen[cc],
                    tlen[cc], ir0, ir1, logm)
            fx = np.nonzero(flags[qid[cc]] | flags[tid[cc]])[0]
            if len(fx):
                h = _consensus_likelihood_host(
                    seqdb, qid, tid, qs, qe, ts, te, alen, logm,
                    cc[fx], max_len)
                total[fx] = h["total"]
                lik[fx] = h["lik_mod"]
                idc2[fx] = -1  # use host ratios directly below
                hs, hr = h["seq_id"], h["ry_seq_id"]
            has = total > 0
            sid_c = np.where(
                has, (idc2.astype(np.float32)
                      / np.maximum(total, 1).astype(np.float32))
                .astype(np.float64), seq_id[cc])
            ry_c = np.where(
                has, (ryc2.astype(np.float32)
                      / np.maximum(total, 1).astype(np.float32))
                .astype(np.float64), ry_seq_id[cc])
            if len(fx):
                sid_c[fx] = np.where(h["has"], hs, seq_id[cc[fx]])
                ry_c[fx] = np.where(h["has"], hr, ry_seq_id[cc[fx]])
            seq_id[cc] = np.where(valid, sid_c, seq_id[cc])
            ry_seq_id[cc] = np.where(valid, ry_c, ry_seq_id[cc])
            side_total[cc] = np.where(valid, total, 0)
            side_is_left[cc] = left_c
            side_valid[cc] = valid
            lik_mod[cc] = np.where(valid, lik, 0.0)
            aln_count[cc] = np.where(valid, total, 0)
        res = _finish(cand, seq_id, ry_seq_id, side_total, side_is_left,
                      side_valid, lik_mod, aln_count)
        # ---- exact precision guard -----------------------------------
        # the device likelihood sums are f32; queue membership AND queue
        # ORDER compare s_len_norm down to the last f64 ulp (the reference
        # rounds an 80-bit accumulator to double — exact ties at scale are
        # real, see the 5M divergence bisection), so EVERY queue entrant
        # is re-evaluated by the exact long-double host path.
        not_inside = tlen != alen
        queue_pre = cand & ((ts == 0) | (qs == 0)) & not_inside \
            & not_identity \
            & (ry_seq_id.astype(np.float32) >= np.float32(ry_seq_id_thr)) \
            & (seq_id.astype(np.float32) >= np.float32(seq_id_thr))
        is_left_like = (qs == 0) & (te == tlen - 1)
        max_aln_all = np.where(is_left_like, res["max_left"][qid],
                               res["max_right"][qid])
        sub = np.nonzero(queue_pre)[0]
        if len(sub):
            # exact recompute: the native per-record pass (the same C++
            # that backs the host path below)
            from .. import native
            _st_f64 = subtimer("ext.f64_guard_host")
            _st_f64.__enter__()
            nat = native.read_prepass(
                data, offsets, seqdb.lengths, qid[sub].astype(np.int32),
                tid[sub].astype(np.int32), qs[sub].astype(np.int32),
                qe[sub].astype(np.int32), ts[sub].astype(np.int32),
                te[sub].astype(np.int32), alen[sub].astype(np.int32),
                (terminal & not_identity)[sub].astype(np.uint8),
                seqdb.ext[tid[sub]].astype(np.uint8), float(seq_id_thr),
                logm)
            lm = np.where(nat["cons_valid"], nat["lik_mod"],
                          np.longdouble(0.0))
            ac = np.where(nat["cons_valid"], nat["aln_count"], 0)
            sln, sr = _exact_sln_ratio(lm, ac, max_aln_all[sub])
            res["s_len_norm"][sub] = sln
            res["s_ratio"][sub] = sr
            res["queue_ok"][sub] = queue_pre[sub] & (sr > likelihood_thr)
            _st_f64.__exit__()
        return res

    # ---- host path: passes A-C + consensus + likelihood in C++ ----------
    from .. import native
    nat = native.read_prepass(
        data, offsets, seqdb.lengths, qid.astype(np.int32),
        tid.astype(np.int32), qs.astype(np.int32), qe.astype(np.int32),
        ts.astype(np.int32), te.astype(np.int32), alen.astype(np.int32),
        (terminal & not_identity).astype(np.uint8),
        seqdb.ext[tid].astype(np.uint8), float(seq_id_thr), logm)
    cand = nat["cand"]
    seq_id = nat["seq_id"]
    ry_seq_id = nat["ry_seq_id"]
    max_left = np.zeros(n_seq, dtype=np.int64)
    max_right = np.zeros(n_seq, dtype=np.int64)
    cc = np.nonzero(cand & nat["cons_valid"])[0]
    lmask = nat["cons_left"][cc]
    np.maximum.at(max_left, qid[cc[lmask]], nat["cons_total"][cc[lmask]])
    np.maximum.at(max_right, qid[cc[~lmask]],
                  nat["cons_total"][cc[~lmask]])
    not_inside = tlen != alen
    queue_pre = cand & ((ts == 0) | (qs == 0)) & not_inside \
        & not_identity \
        & (ry_seq_id.astype(np.float32) >= np.float32(ry_seq_id_thr)) \
        & (seq_id.astype(np.float32) >= np.float32(seq_id_thr))
    is_left_like = (qs == 0) & (te == tlen - 1)
    max_aln = np.where(is_left_like, max_left[qid], max_right[qid])
    s_len_norm, s_ratio = _exact_sln_ratio(nat["lik_mod"],
                                           nat["aln_count"], max_aln)
    queue_ok = queue_pre & (s_ratio > likelihood_thr)
    return {"cand": cand, "seq_id": seq_id, "ry_seq_id": ry_seq_id,
            "queue_ok": queue_ok, "s_len_norm": s_len_norm,
            "s_ratio": s_ratio, "max_left": max_left,
            "max_right": max_right}


def _pass_b_identity_host(seqdb, qid, tid, is_rev, qs, ts, win):
    """Chunked NumPy pass-B identity counts (exact raw-char semantics)."""
    from ..constants import CHAR_REVCOMP
    data = seqdb.data
    offsets = seqdb.offsets
    rc_flat = CHAR_REVCOMP[data]
    ry_flat = CHAR_TO_RY[data]
    ry_rc_flat = CHAR_TO_RY[rc_flat]
    tlen = seqdb.lengths[tid]
    n_rec = len(qid)
    max_len = int(win.max()) if n_rec else 1
    pos = np.arange(max_len, dtype=np.int64)[None, :]
    idc = np.zeros(n_rec, dtype=np.int64)
    ryc = np.zeros(n_rec, dtype=np.int64)
    chunk = _chunk_for(max_len)
    for c0 in range(0, n_rec, chunk):
        sl = slice(c0, min(c0 + chunk, n_rec))
        qoff, toff = offsets[qid[sl]], offsets[tid[sl]]
        tlr, rev = tlen[sl], is_rev[sl]
        in_win = pos < win[sl][:, None]
        qg = np.clip(qoff[:, None] + qs[sl][:, None] + pos, 0, len(data) - 1)
        tp = ts[sl][:, None] + pos
        fwd_idx = np.clip(toff[:, None] + tp, 0, len(data) - 1)
        rev_idx = np.clip(toff[:, None] + tlr[:, None] - 1 - tp,
                          0, len(data) - 1)
        tch = np.where(rev[:, None], rc_flat[rev_idx], data[fwd_idx])
        tr_ry = np.where(rev[:, None], ry_rc_flat[rev_idx],
                         ry_flat[fwd_idx])
        idc[sl] = ((data[qg] == tch) & in_win).sum(axis=1)
        ryc[sl] = ((ry_flat[qg] == tr_ry) & in_win).sum(axis=1)
    return idc, ryc


def batch_contig_scoring(seqdb, aln, damage, merge_seq_id_thr: float,
                         ry_seq_id_thr: float) -> dict:
    """Batched initial pass of ancient_contig_merge (safe mode): strand
    canonicalisation, pass-B identities, consensus update (consensus ==
    query) and the damage-discounted `ancientMatchCount`, for every
    alignment record at once.

    Returns per-record arrays: cand, qs/qe/ts/te (canonical), is_rev,
    seq_id, ry_seq_id, aln_len_cons, deam_match, queue_ok."""
    qid = seqdb.lookup_keys(aln.qkey).astype(np.int64)
    tid = seqdb.lookup_keys(aln.cols["tkey"]).astype(np.int64)
    qs0 = aln.cols["qstart"].astype(np.int64)
    qe0 = aln.cols["qend"].astype(np.int64)
    ts0 = aln.cols["dbstart"].astype(np.int64)
    te0 = aln.cols["dbend"].astype(np.int64)
    tlen = seqdb.lengths[tid]
    alen = aln.aln_len.astype(np.int64)
    is_rev = qs0 > qe0
    qs = np.where(is_rev, qe0, qs0)
    qe = np.where(is_rev, qs0, qe0)
    ts = np.where(is_rev, tlen - te0 - 1, ts0)
    te = np.where(is_rev, tlen - ts0 - 1, te0)
    not_identity = aln.cols["tkey"].astype(np.int64) \
        != aln.qkey.astype(np.int64)

    # ---- the whole pre-pass in one C++ call (native/prepass.cpp); the
    # JAX package's device pass-B for this phase is not ported yet --------
    from .. import native
    nat = native.contig_prepass(
        seqdb.data, seqdb.offsets, seqdb.lengths,
        qid.astype(np.int32), tid.astype(np.int32),
        is_rev.astype(np.uint8), qs.astype(np.int32),
        qe.astype(np.int32), ts.astype(np.int32), te.astype(np.int32),
        alen.astype(np.int32), not_identity.astype(np.uint8),
        float(merge_seq_id_thr), float(ry_seq_id_thr),
        damage.fwd[5], damage.rev[5])
    min_aln_len = np.where(
        alen < 500, np.minimum(500, (0.2 * tlen).astype(np.int64)), 500)
    queue_ok = nat["cand"] \
        & (nat["seq_id"].astype(np.float32) >= np.float32(merge_seq_id_thr)) \
        & (nat["ry_seq_id"].astype(np.float32) >= np.float32(ry_seq_id_thr)) \
        & (alen >= min_aln_len)
    return {"cand": nat["cand"], "qs": qs, "qe": qe, "ts": ts, "te": te,
            "is_rev": is_rev, "seq_id": nat["seq_id"],
            "ry_seq_id": nat["ry_seq_id"],
            "aln_len_cons": nat["aln_len_cons"],
            "deam_match": nat["deam_match"], "queue_ok": queue_ok}
