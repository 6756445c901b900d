"""rescorediagonal on the card: ungapped end-to-end overlap scoring of
every prefilter pair (kernel: csrc/rescore.cu).

Port of carpedeam_tpu/ops/rescore_pallas.py:155-352.  `rescore_pairs`
launches the CUDA kernel on CUDA tensors and runs `rescore_pairs_reference`
(the same function in plain tensor ops) on CPU tensors.  One int32 per
pair comes back (score bits 0-15, id_cnt bits 16-30, use_pos in the sign
bit); coordinates are recomputed on the host by `unpack_rescore`.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import KERNELS
from .planes import device_planes, to_device

# device length levels: pairs are scored in the narrowest level that
# holds both sequences; beyond the last level the native host scorer
# takes over (the same levels as the JAX package, so both route the
# same pairs)
LEN_LEVELS = (512, 2048, 8192, 16384)

RESCORE = KERNELS["rescore_pairs"]


def _check_inputs(code2, sym2, lengths, pairs):
    dev = code2.device
    for name, t, dt in (("code2", code2, torch.uint8),
                        ("sym2", sym2, torch.uint8),
                        ("lengths", lengths, torch.int32),
                        ("pairs", pairs, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, code2 on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if code2.dim() != 2 or code2.shape != sym2.shape:
        raise ValueError("code2 and sym2 must be the same (2N, L) shape")
    if code2.shape[0] != 2 * lengths.shape[0]:
        raise ValueError("planes must hold 2 * len(lengths) rows")
    if pairs.dim() != 2 or pairs.shape[1] != 3:
        raise ValueError("pairs must be (P, 3) int32")


def rescore_pairs(code2: torch.Tensor, sym2: torch.Tensor,
                  lengths: torch.Tensor, pairs: torch.Tensor
                  ) -> torch.Tensor:
    """Packed (P, 1) int32 scores of `pairs` (P, 3) int32: col 0 qidx with
    is_rev in the sign bit, col 1 tidx, col 2 prefilter diagonal (low 16
    bits, unsigned-short semantics).  code2/sym2 are the (2N, L) stacked
    planes, lengths (N,) int32."""
    _check_inputs(code2, sym2, lengths, pairs)
    if code2.device.type == "cpu":
        return rescore_pairs_reference(code2, sym2, lengths, pairs)
    if code2.data_ptr() % 16 or sym2.data_ptr() % 16:
        raise ValueError("code2 and sym2 must be 16-byte aligned (the "
                         "kernel reads them in aligned 16-byte words)")
    out = torch.empty((pairs.shape[0], 1), dtype=torch.int32,
                      device=code2.device)
    RESCORE.launch(code2.data_ptr(), sym2.data_ptr(), lengths.data_ptr(),
                   pairs.data_ptr(), pairs.shape[0], lengths.shape[0],
                   code2.shape[1], out.data_ptr(),
                   torch.cuda.current_stream(code2.device).cuda_stream)
    return out


def rescore_pairs_reference(code2, sym2, lengths, pairs) -> torch.Tensor:
    """Plain tensor version of the rescore kernel (same packed output)."""
    dev = code2.device
    L = code2.shape[1]
    n_seqs = lengths.shape[0]
    qp = pairs[:, 0].to(torch.int64)
    is_rev = qp < 0
    qidx = qp & 0x7FFFFFFF
    tidx = pairs[:, 1].to(torch.int64)
    diag_u = pairs[:, 2].to(torch.int64) & 0xFFFF
    qlen = lengths[qidx].to(torch.int64)
    tlen = lengths[tidx].to(torch.int64)
    qrow = qidx + torch.where(is_rev, n_seqs, 0)
    qc, tc = code2[qrow].to(torch.int64), code2[tidx].to(torch.int64)
    qs, ts = sym2[qrow].to(torch.int64), sym2[tidx].to(torch.int64)
    pos = torch.arange(L, device=dev, dtype=torch.int64)[None, :]

    def rolled(x, shift):
        return torch.gather(x, 1, (pos + shift[:, None]) % L)

    def score(qw, tw, min_len, valid):
        match = (qw == tw) & (qw < 4) & (pos < min_len[:, None])
        m = match.sum(dim=1)
        s = torch.clamp(2 * m - 3 * (min_len - m), min=0)
        return torch.where(valid, s, 0)

    zero = torch.zeros_like(diag_u)
    dist_neg = 65536 - diag_u
    valid_neg = dist_neg < tlen
    len_neg = torch.where(valid_neg, torch.minimum(tlen - dist_neg, qlen), 0)
    s_neg = score(qc, rolled(tc, torch.where(valid_neg, dist_neg, zero)),
                  len_neg, valid_neg)
    dist_pos = diag_u
    valid_pos = dist_pos < qlen
    len_pos = torch.where(valid_pos, torch.minimum(tlen, qlen - dist_pos), 0)
    s_pos = score(rolled(qc, torch.where(valid_pos, dist_pos, zero)), tc,
                  len_pos, valid_pos)

    use_pos = s_pos > s_neg
    best_score = torch.where(use_pos, s_pos, s_neg)
    best_len = torch.where(use_pos, len_pos, len_neg)
    best_dist = torch.where(use_pos, dist_pos, dist_neg)
    got = best_score > 0
    start = torch.where(got, 0, -1)
    end = torch.where(got, best_len - 1, -1)
    dist = torch.where(got, best_dist, 0)
    dneg = got & ~use_pos
    qstart = torch.where(dneg, start, start + dist)
    tstart = torch.where(dneg, start + dist, start)
    aln_len = end - start + 1
    sh_q = torch.clamp(qstart, min=0)
    sh_t = torch.clamp(tstart, min=0)
    q_off = torch.where(sh_q > 0, sh_q + sh_t, 0)
    t_off = torch.where(sh_q > 0, 0, sh_q + sh_t)
    id_cnt = ((rolled(qs, q_off) == rolled(ts, t_off))
              & (pos < aln_len[:, None])).sum(dim=1)
    packed = best_score + (id_cnt << 16)
    packed = torch.where(use_pos, packed | (1 << 31), packed)
    # two's-complement int32 of the 32-bit pattern
    packed = torch.where(packed >= (1 << 31), packed - (1 << 32), packed)
    return packed.to(torch.int32)[:, None]


def unpack_rescore(packed_np, lengths, qidx, tidx, diag):
    """Recompute the per-pair field dict from the packed int32 kernel
    output (host side, vectorised).  Coordinates replay the kernel's
    candidate-selection arithmetic exactly from (diag, qlen, tlen,
    use_pos, got); only score/id_cnt/use_pos cross the device->host
    link."""
    v = np.ascontiguousarray(packed_np[:, 0]).view(np.uint32)
    score = (v & 0xFFFF).astype(np.int64)
    id_cnt = ((v >> 16) & 0x7FFF).astype(np.int64)
    use_pos = (v >> 31).astype(bool)

    qlen = lengths[qidx].astype(np.int64)
    tlen = lengths[tidx].astype(np.int64)
    diag_u = diag.astype(np.int64) & 0xFFFF
    cand = np.where(use_pos, diag_u, diag_u - 65536)
    neg = cand < 0
    dist_c = np.abs(cand)
    valid = np.where(neg, dist_c < tlen, dist_c < qlen)
    min_len = np.where(neg, np.minimum(tlen - dist_c, qlen),
                       np.minimum(tlen, qlen - dist_c))
    min_len = np.where(valid, min_len, 0)

    got = score > 0
    start = np.where(got, 0, -1)
    end = np.where(got, min_len - 1, -1)
    dist = np.where(got, dist_c, 0)
    dneg = got & neg
    qstart = np.where(dneg, start, start + dist)
    tstart = np.where(dneg, start + dist, start)
    aln_len = end - start + 1
    return {"score": score, "qstart": qstart, "tstart": tstart,
            "aln_len": aln_len, "id_cnt": id_cnt,
            "qend": qstart + aln_len - 1, "tend": tstart + aln_len - 1,
            "qlen": qlen, "tlen": tlen}


def rescorediagonal_cuda(seqdb, pref, seq_id_thr, eval_thr=0.001,
                         aln_len_thr=0, planes=None, lengths=None,
                         device="cuda"):
    """Device drop-in for stages.rescorediagonal.rescorediagonal.

    Pairs are partitioned by length level (max of the two sequence
    lengths): the shared whole-DB planes serve the <= 512 level, longer
    levels pack per-level planes holding only the referenced sequences;
    pairs beyond the last level go to the native host scorer,
    bit-identically.  With `planes` given, the kernels run on the planes'
    device; else on `device`."""
    from ..stages.rescorediagonal import (_score_pairs_native,
                                          assemble_alndb)
    from ..utils import bucket_len, coverage_add, subtimer

    dev = planes["sym"].device if planes is not None \
        else torch.device(device)
    with subtimer("rescore.host_prep"):
        n = len(pref.qkey)
        qidx_all = seqdb.lookup_keys(pref.qkey).astype(np.int32)
        tidx_all = seqdb.lookup_keys(pref.tkey).astype(np.int32)
        qlen_all = seqdb.lengths[qidx_all].astype(np.int64)
        tlen_all = seqdb.lengths[tidx_all].astype(np.int64)
        pair_max = np.maximum(qlen_all, tlen_all)
        diag_all = pref.diag.astype(np.int32)
        rev_all = pref.score < 0

        raw = {f: np.zeros(n, dtype=np.int64) for f in
               ("score", "qstart", "qend", "tstart", "tend", "aln_len",
                "id_cnt")}
        raw["qlen"] = qlen_all
        raw["tlen"] = tlen_all

    done = np.zeros(n, dtype=bool)
    for lvl in LEN_LEVELS:
        rows = np.nonzero(~done & (pair_max <= lvl))[0]
        done |= pair_max <= lvl
        if not len(rows):
            continue
        if lvl == LEN_LEVELS[0] and planes is not None:
            pl_b = planes
            q_b, t_b = qidx_all[rows], tidx_all[rows]
        else:
            with subtimer(f"rescore.planes_lvl{lvl}"):
                sub = np.unique(np.concatenate([qidx_all[rows],
                                                tidx_all[rows]]))
                remap = np.full(len(seqdb), -1, dtype=np.int32)
                remap[sub] = np.arange(len(sub), dtype=np.int32)
                pl_b, _ = device_planes(
                    seqdb, max_len=bucket_len(min(lvl, int(pair_max[rows]
                                                           .max()))),
                    ids=sub, device=dev)
                q_b, t_b = remap[qidx_all[rows]], remap[tidx_all[rows]]
        pairs = np.empty((len(rows), 3), dtype=np.int32)
        pairs[:, 0] = q_b | np.where(rev_all[rows], np.int32(-2147483648),
                                     np.int32(0))
        pairs[:, 1] = t_b
        pairs[:, 2] = diag_all[rows]
        with subtimer(f"rescore.device_lvl{lvl}"):
            out = rescore_pairs(pl_b["code"], pl_b["sym"], pl_b["len"],
                                to_device(pairs, dev))
            packed = out.cpu().numpy()
        with subtimer(f"rescore.unpack_lvl{lvl}"):
            sraw = unpack_rescore(packed, seqdb.lengths, qidx_all[rows],
                                  tidx_all[rows], diag_all[rows])
            for f in raw:
                if f not in ("qlen", "tlen"):
                    raw[f][rows] = sraw[f]

    rest = np.nonzero(~done)[0]
    coverage_add("rescorediagonal", n - len(rest), len(rest))
    if len(rest):
        # beyond the device levels: native host scorer on those rows only
        sub_pref = type(pref)(qkey=pref.qkey[rest], tkey=pref.tkey[rest],
                              score=pref.score[rest], diag=pref.diag[rest],
                              starts=np.array([0, len(rest)], np.int64),
                              qkeys=pref.qkeys[:1], qext=pref.qext[:1])
        sraw = _score_pairs_native(seqdb, sub_pref)
        for f in raw:
            raw[f][rest] = sraw[f].astype(np.int64)
    with subtimer("rescore.assemble"):
        return assemble_alndb(seqdb, pref, raw, seq_id_thr, eval_thr,
                              aln_len_thr)
