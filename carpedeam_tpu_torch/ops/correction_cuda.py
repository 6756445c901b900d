"""Fused Bayesian correction on the card (kernel: csrc/correction.cu).

Port of carpedeam_tpu/ops/correction_pallas.py:327-700 (reference
semantics: src/assembler/correction.cpp:7-123,200-463).  Queries are
packed into blocks of G query slots whose surviving alignment records
fit R record slots (records of one query are contiguous, so each block
owns complete coverage stacks); the kernel aligns each record to its
query frame, applies the RY gate, counts the 44 (base x damage layer)
classes per position, and takes the f32 Bayesian argmax, writing 2-bit
bases packed four slots per byte.  `correction_kernel` launches it on
CUDA tensors and runs `correction_kernel_reference` (plain tensor ops,
same f32 rounding order) on CPU tensors.

Queries are levelled by length (CORR_LEN_LEVELS); non-ACGT queries,
stacks deeper than R and queries beyond the last level take the exact
per-query host oracle, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import KERNELS
from ..constants import SMOOTHING_VALUE
from ..damage import DamageModel, seq_error_profile
from ..io.seqdb import SeqDB
from .planes import (HostCopy, assemble_planes, device_planes, lookup,
                     row_chunks, to_device)

G = 32           # default query slots per block (see _tiles_for)
REC_TILE = 256   # default record slots per block

CORRECTION = KERNELS["correction"]


def _tiles_for(max_len: int) -> tuple[int, int]:
    """(query slots, record slots) per block: the JAX package's tiles,
    kept so both packages pack the same blocks and route the same stacks
    (deeper than the record tile) to the host oracle.  The CUDA kernel
    takes any G divisible by 4 up to 128 and R up to 512."""
    if max_len <= 128:
        return 128, 512
    if max_len <= 512:
        return 32, 128
    if max_len <= 1024:
        return 32, 64
    return 32, 32


def _slot_row_index(slot_pos, g: int):
    """Row index of slot `slot_pos` (= block*G + slot) inside the decoded
    `codes` array of derive_corrected_planes: the four bit-pair slices
    of quarter-row r are interleaved at rows 4*r + j."""
    b = slot_pos // g
    s = slot_pos % g
    quarter = g // 4
    return (b * quarter + (s % quarter)) * 4 + s // quarter


def build_correction_blocks(rec, lengths, n_seqs, g: int = G,
                            rec_tile: int = REC_TILE, heavy_mask=None):
    """Pack queries (with their surviving records) into (g, rec_tile)
    blocks.  Returns None when no query is left for the device (nothing
    survived the pre-filters, or every stack is heavy).  Queries owning
    more than rec_tile records are listed in `heavy_qids` for the host
    oracle.  `heavy_mask` marks additional per-sequence ids to route
    through the host per-query oracle."""
    G, REC_TILE = g, rec_tile

    keep = rec["rec_keep_pre"]
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        # nothing survived the pre-filters (empty AlnDB, or e.g. a
        # contig-phase where every target has ext=True): no blocks
        return None
    q = rec["rec_q"][idx]
    order = np.argsort(q, kind="stable")
    idx = idx[order]
    q = q[order]
    uq, starts, cnts = np.unique(q, return_index=True, return_counts=True)
    is_heavy = cnts > REC_TILE
    if heavy_mask is not None:
        is_heavy |= heavy_mask[uq]
    heavy_qids = uq[is_heavy]
    if len(heavy_qids):
        light = ~is_heavy
        keep_rec = np.isin(q, uq[light])
        idx = idx[keep_rec]
        q = q[keep_rec]
        uq, starts, cnts = uq[light], None, cnts[light]
        starts = np.concatenate([[0], np.cumsum(cnts)])[:-1]
    nq = len(uq)
    if nq == 0:
        # only heavy stacks remain: the host oracle handles the whole DB
        return None
    nrec = len(q)
    cum = np.concatenate([[0], np.cumsum(cnts)])

    # greedy pack boundaries: one loop per BLOCK (not per query)
    bstart = []
    pos = 0
    while pos < nq:
        bstart.append(pos)
        j_rec = int(np.searchsorted(cum, cum[pos] + REC_TILE,
                                    side="right")) - 1
        pos = min(pos + G, max(j_rec, pos + 1))
    bstart = np.asarray(bstart, dtype=np.int64)
    bend = np.concatenate([bstart[1:], [nq]])
    # (the TPU package pads nb to a multiple of 128 to reuse one compiled
    # executable; a CUDA grid compiles nothing per shape)
    nb = len(bstart)

    # vectorised slot assignment
    block_of_q = np.repeat(np.arange(len(bstart)), bend - bstart)
    slot_of_q = np.arange(nq) - bstart[block_of_q]
    rank = np.repeat(np.arange(nq), cnts)          # query rank per record
    blk_r = block_of_q[rank]
    ridx = np.arange(nrec) - cum[bstart[blk_r]]    # record pos in block
    rec_pos = blk_r * REC_TILE + ridx

    rec_sel = np.zeros(nb * REC_TILE, dtype=np.int64)
    rec_use = np.zeros(nb * REC_TILE, dtype=bool)
    qslot = np.zeros((nb, 8, REC_TILE), dtype=np.int32)
    qslot[:, 0, :] = G  # no slot
    rec_sel[rec_pos] = np.arange(nrec)
    rec_use[rec_pos] = True
    qslot0 = np.full(nb * REC_TILE, G, dtype=np.int32)
    qslot0[rec_pos] = slot_of_q[rank]
    qslot[:, 0, :] = qslot0.reshape(nb, REC_TILE)
    slot_qid = np.zeros(nb * G, dtype=np.int32)
    slot_valid = np.zeros(nb * G, dtype=bool)
    slot_pos = block_of_q * G + slot_of_q
    slot_qid[slot_pos] = uq
    slot_valid[slot_pos] = True
    sel = idx[rec_sel]  # indices into the original record arrays
    return {"nb": nb, "sel": sel, "use": rec_use,
            "qslot": qslot, "slot_qid": slot_qid,
            "slot_valid": slot_valid, "heavy_qids": heavy_qids}


def correction_wtab(damage: DamageModel) -> np.ndarray:
    """(48, 16) f32 table of the correction kernel: rows t*11+l hold
    log max(fwd[l, q, t], 1e-3) in columns 0-3 and the reverse-strand
    tensor's in 4-7; rows 44+t hold log seqErr(0.01)[q, t] in 0-3."""
    seq_err = seq_error_profile(0.01)
    log_err = np.log(seq_err).astype(np.float32)
    log_f = np.log(np.maximum(damage.fwd, SMOOTHING_VALUE)).astype(np.float32)
    log_r = np.log(np.maximum(damage.rev, SMOOTHING_VALUE)).astype(np.float32)
    wtab = np.zeros((48, 16), dtype=np.float32)
    for t in range(4):
        for l in range(11):
            wtab[t * 11 + l, 0:4] = log_f[l, :, t]
            wtab[t * 11 + l, 4:8] = log_r[l, :, t]
        # log_q_err[p, q] = log_err[q, obs[p]]
        wtab[44 + t, 0:4] = log_err[:, t]
    return wtab


def _check_kernel_inputs(sym2, rec_rows, rscal, slot_qid, qscal, wtab,
                         g, rec_tile):
    dev = sym2.device
    for name, t, dt in (("sym2", sym2, torch.uint8),
                        ("rec_rows", rec_rows, torch.int32),
                        ("rscal", rscal, torch.int32),
                        ("slot_qid", slot_qid, torch.int32),
                        ("qscal", qscal, torch.int32),
                        ("wtab", wtab, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, sym2 on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g % 4 or g > 128 or rec_tile > 512:
        raise ValueError(f"unsupported tile (g={g}, rec_tile={rec_tile})")
    nb = slot_qid.shape[0] // g
    if slot_qid.shape[0] != nb * g or rec_rows.shape[0] != nb * rec_tile \
            or tuple(rscal.shape) != (nb * rec_tile, 8) \
            or tuple(qscal.shape) != (nb * g, 8) \
            or tuple(wtab.shape) != (48, 16) or sym2.dim() != 2:
        raise ValueError("inconsistent correction block shapes")
    return nb


def correction_kernel(sym2, rec_rows, rscal, slot_qid, qscal, wtab,
                      g: int, rec_tile: int) -> torch.Tensor:
    """Corrected 2-bit bases, (nb*g/4, L) uint8, of nb blocks of g query
    slots and rec_tile record slots.  sym2: (2N, L) uint8 symbol planes;
    rec_rows (nb*rec_tile,) int32 plane rows of the records; rscal
    (nb*rec_tile, 8) int32 (qstart, tstart, alen, tlen, ry_smin, use,
    slot, is_rev); slot_qid (nb*g,) int32 plane rows of the slots' queries;
    qscal (nb*g, 8) int32 (qlen, was_ext, 0...); wtab (48, 16) f32."""
    nb = _check_kernel_inputs(sym2, rec_rows, rscal, slot_qid, qscal, wtab,
                              g, rec_tile)
    if sym2.device.type == "cpu":
        return correction_kernel_reference(sym2, rec_rows, rscal, slot_qid,
                                           qscal, wtab, g, rec_tile)
    for name, t in (("rscal", rscal), ("qscal", qscal), ("wtab", wtab)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"stages it in 16-byte copies)")
    L = sym2.shape[1]
    out = torch.empty((nb * g // 4, L), dtype=torch.uint8,
                      device=sym2.device)
    # scratch: the per-record keep flags (the launch takes the RY gate of
    # every record in a first pass, which each position tile reads)
    keep = torch.empty(nb * rec_tile, dtype=torch.uint8, device=sym2.device)
    CORRECTION.launch(sym2.data_ptr(), L, rec_rows.data_ptr(),
                      rscal.data_ptr(), slot_qid.data_ptr(),
                      qscal.data_ptr(), wtab.data_ptr(), nb, g, rec_tile,
                      keep.data_ptr(), out.data_ptr(),
                      torch.cuda.current_stream(sym2.device).cuda_stream)
    return out


def _acgt_code(x: torch.Tensor) -> torch.Tensor:
    c = torch.zeros_like(x)
    c = torch.where(x == ord("C"), 1, c)
    c = torch.where(x == ord("G"), 2, c)
    return torch.where(x == ord("T"), 3, c)


def correction_kernel_reference(sym2, rec_rows, rscal, slot_qid, qscal,
                                wtab, g: int, rec_tile: int
                                ) -> torch.Tensor:
    """Plain tensor version of the correction kernel: the same counts
    (integer), the same f32 products and sums in the same order."""
    dev = sym2.device
    L = sym2.shape[1]
    nb = slot_qid.shape[0] // g
    n_rec = nb * rec_tile
    pos = torch.arange(L, device=dev, dtype=torch.int64)[None, :]
    r = rscal.to(torch.int64)
    qstart, tstart, alen, tlen = r[:, 0:1], r[:, 1:2], r[:, 2:3], r[:, 3:4]
    smin, keep_pre, qslot, is_rev = r[:, 4:5], r[:, 5:6], r[:, 6], r[:, 7:8]

    t_sym = sym2[rec_rows.to(torch.int64)].to(torch.int64)
    shift = (tstart - qstart) % L
    t_aln = torch.gather(t_sym, 1, (pos + shift) % L)
    in_aln = (pos >= qstart) & (pos < qstart + alen)

    slot_sym = sym2[slot_qid.to(torch.int64)].to(torch.int64)   # (nb*g, L)
    blk = torch.arange(n_rec, device=dev) // rec_tile
    has_slot = qslot < g
    slot_global = torch.where(has_slot, blk * g + qslot, nb * g)
    q_sym = torch.cat([slot_sym, torch.zeros((1, L), dtype=torch.int64,
                                             device=dev)])[slot_global]
    is_ct = lambda x: (x == ord("C")) | (x == ord("T"))  # noqa: E731
    ry_cnt = (in_aln & (is_ct(q_sym) == is_ct(t_aln))).sum(dim=1,
                                                            keepdim=True)
    keep = (keep_pre != 0) & (ry_cnt >= smin)

    t_real = tstart + pos - qstart
    layer = torch.where(t_real < 5, t_real, 5)
    from_end = t_real - (tlen - 5)
    layer = torch.where(from_end >= 0, 6 + from_end, layer)
    # aligned, kept columns with a class (0-43; larger ids have none) of
    # records that belong to a slot
    cls = _acgt_code(t_aln) * 11 + layer
    hit = in_aln & keep & (cls < 44) & has_slot[:, None]
    r_idx, p_idx = hit.nonzero(as_tuple=True)
    c_idx = cls[r_idx, p_idx]

    # only (slot, position) cells that some record covers can change;
    # every other cell keeps its base (coverage < 2)
    cells, cell_of = torch.unique(slot_global[r_idx] * L + p_idx,
                                  return_inverse=True)
    ones = torch.ones_like(c_idx, dtype=torch.int32)
    c_all = torch.zeros((len(cells), 44), dtype=torch.int32, device=dev) \
        .index_put_((cell_of, c_idx), ones, accumulate=True)
    rev = (is_rev[r_idx, 0] != 0)
    c_rev = torch.zeros((len(cells), 44), dtype=torch.int32, device=dev) \
        .index_put_((cell_of[rev], c_idx[rev]), ones[rev], accumulate=True)

    # per covered cell: f32 likelihood in the kernel's order (classes
    # ascending; (lik + F*w_fwd) + R*w_rev), then the prior tot*log_q
    w = wtab
    lik = [torch.zeros(len(cells), dtype=torch.float32, device=dev)
           for _ in range(4)]
    for c in range(44):
        f = (c_all[:, c] - c_rev[:, c]).to(torch.float32)
        rf = c_rev[:, c].to(torch.float32)
        for q in range(4):
            lik[q] = (lik[q] + f * w[c, q]) + rf * w[c, 4 + q]
    base_cov = [c_all[:, t * 11:(t + 1) * 11].sum(dim=1) for t in range(4)]
    tot = base_cov[0] + base_cov[1] + base_cov[2] + base_cov[3]

    slot, p = cells // L, cells % L
    qs = qscal.to(torch.int64)
    qlen = qs[slot, 0]
    was_ext = qs[slot, 1] != 0
    obs_all = _acgt_code(slot_sym)
    obs = obs_all[slot, p]
    own = torch.where(p < 5, p, 5)
    own = torch.where(p - (qlen - 5) >= 0, 6 + p - (qlen - 5), own)
    dam_row = obs * 11 + torch.clamp(own, max=10)
    tot_f = tot.to(torch.float32)
    for q in range(4):
        dam = torch.where(own <= 10, w[:, q][dam_row], 0.0)
        log_q = torch.where(was_ext, w[:, q][44 + obs], dam)
        lik[q] = lik[q] + tot_f * log_q

    best = lik[0]
    bi = torch.zeros(len(cells), dtype=torch.int64, device=dev)
    for q in range(1, 4):
        upd = lik[q] > best
        best = torch.where(upd, lik[q], best)
        bi = torch.where(upd, q, bi)
    ratio_exit = (~was_ext) & ((5 * base_cov[3] >= 2 * tot)
                               | (5 * base_cov[0] >= 2 * tot))
    final = obs_all.reshape(-1).clone()
    final[cells] = torch.where(ratio_exit | (tot < 2), obs, bi)
    fq = final.reshape(nb, 4, g // 4, L)
    packed = fq[:, 0] + 4 * fq[:, 1] + 16 * fq[:, 2] + 64 * fq[:, 3]
    return packed.reshape(nb * g // 4, L).to(torch.uint8)


def derive_corrected_planes(sym2, lengths, packed, src_slot) -> dict:
    """Rebuild the corrected shared planes on the device from the kernel's
    packed 2-bit output: each sequence's corrected row is decoded slot
    src_slot (bit pair src % 4 of packed row src // 4, the interleave of
    _slot_row_index), or its original row where src_slot < 0 (the query
    had no device slot, so correction left it unchanged).  Lengths are
    unchanged by correction, so the rc and code planes re-derive as
    usual.  In row chunks (planes.row_chunks)."""
    L = packed.shape[1]
    n = lengths.shape[0]
    dev = sym2.device
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    pos = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    last = packed.shape[0] * 4 - 1
    new_fwd = torch.empty((n, L), dtype=torch.uint8, device=dev)
    for a, b in row_chunks(n, L):
        src = src_slot[a:b].to(torch.int32)
        s = src.clamp(0, last)
        shift = (2 * (s % 4)).to(torch.uint8)[:, None]
        picked = lookup(acgt, (packed.index_select(0, s // 4) >> shift) & 3)
        keep = (src >= 0)[:, None] & (pos < lengths[a:b].to(torch.int32)
                                      [:, None])
        new_fwd[a:b] = torch.where(keep, picked, sym2[a:b])
    return assemble_planes(new_fwd, lengths)


# device length levels for correction: queries run in the narrowest
# level holding the query AND every target in its surviving stack;
# beyond the last level the per-query host oracle takes over.
CORR_LEN_LEVELS = (512, 2048, 4096, 8192)


def _run_correction_level(planes, lens, rec, rows, q_lvl, t_row_lvl,
                          ext_lvl, tlen_lvl, n_lvl, wtab, out_flat,
                          offsets, qid_of, lens_global, sink=None,
                          defer_list=None):
    """One length level: pack blocks, run the fused kernel, write the
    corrected bytes of this level's queries into out_flat.  Returns the
    level's heavy query ids (stacks too deep for the record tile),
    REMAPPED BACK to global ids."""
    from .. import native
    from ..utils import subtimer
    max_len = planes["sym"].shape[1]
    dev = planes["sym"].device
    G, REC_TILE = _tiles_for(max_len)
    rec_lvl = {"rec_keep_pre": rec["rec_keep_pre"][rows],
               "rec_q": q_lvl,
               "rec_qstart": rec["rec_qstart"][rows],
               "rec_tstart": rec["rec_tstart"][rows],
               "rec_alen": rec["rec_alen"][rows],
               "rec_ry_smin": rec["rec_ry_smin"][rows],
               "rec_is_rev": rec["rec_is_rev"][rows]}
    with subtimer(f"corr.blocks_L{max_len}"):
        blocks = build_correction_blocks(rec_lvl, lens, n_lvl, g=G,
                                         rec_tile=REC_TILE)
    if blocks is None:
        return qid_of[np.unique(q_lvl[rec_lvl["rec_keep_pre"]])] \
            if rec_lvl["rec_keep_pre"].any() else np.zeros(0, np.int64)
    nb = blocks["nb"]
    sel, use = blocks["sel"], blocks["use"]

    with subtimer(f"corr.scalars_L{max_len}"):
        rscal = np.zeros((nb * REC_TILE, 8), dtype=np.int32)
        rscal[:, 0] = rec_lvl["rec_qstart"][sel]
        rscal[:, 1] = rec_lvl["rec_tstart"][sel]
        rscal[:, 2] = rec_lvl["rec_alen"][sel]
        rscal[:, 3] = tlen_lvl[sel]
        rscal[:, 4] = rec_lvl["rec_ry_smin"][sel]
        rscal[:, 5] = use  # keep_pre already applied by the block builder
        rscal[:, 6] = blocks["qslot"][:, 0, :].reshape(nb * REC_TILE)
        rscal[:, 7] = rec_lvl["rec_is_rev"][sel] & use

        qscal = np.zeros((nb * G, 8), dtype=np.int32)
        qscal[:, 0] = np.asarray(lens)[blocks["slot_qid"]]
        qscal[:, 1] = ext_lvl[blocks["slot_qid"]] & blocks["slot_valid"]

    with subtimer(f"corr.device_L{max_len}"):
        dev_out = correction_kernel(
            planes["sym"], to_device(t_row_lvl[sel].astype(np.int32), dev),
            to_device(rscal, dev),
            to_device(blocks["slot_qid"].astype(np.int32), dev),
            to_device(qscal, dev), to_device(wtab, dev), G, REC_TILE)
        pull = HostCopy(dev_out)
    if sink is not None:
        sink["dev_out"] = dev_out
        sink["blocks"] = blocks
        sink["g"] = G

    def _pull_and_unpack():
        with subtimer(f"corr.pull_L{max_len}"):
            packed = pull.numpy()
        with subtimer(f"corr.unpack_L{max_len}"):
            native.corr_unpack2_scatter(
                packed, nb, G, max_len, blocks["slot_valid"],
                blocks["slot_qid"], qid_of, lens_global, offsets, out_flat)

    if defer_list is not None:
        # the device->host copy is already streaming; the caller overlaps
        # other work and materialises via the deferred closure
        defer_list.append(_pull_and_unpack)
        return qid_of[blocks["heavy_qids"]]
    _pull_and_unpack()
    return qid_of[blocks["heavy_qids"]]


def correction_cuda(seqdb: SeqDB, aln, damage: DamageModel,
                    corr_reads_ry_seq_id: float, seq_id_thr: float,
                    planes=None, lengths=None,
                    return_planes: bool = False, defer: bool = False,
                    device="cuda"):
    """Device drop-in for stages.correction.correction, length-levelled:
    each query runs in the narrowest device level (CORR_LEN_LEVELS) that
    holds it and every target in its surviving record stack; only
    non-ACGT queries, queries beyond the last level and stacks deeper
    than the record tile use the per-query host oracle.

    `return_planes=True` also returns the corrected shared planes derived
    on the device (or None when they cannot be derived); `defer=True`
    returns a closure that finishes the host pull instead of the DB.
    With `planes` given, the kernels run on the planes' device."""
    from ..stages.correction import prepare_correction_inputs
    from ..utils import bucket_len, coverage_add, log_info, subtimer

    dev = planes["sym"].device if planes is not None \
        else torch.device(device)
    n = len(seqdb)
    with subtimer("corr.prepare_inputs"):
        rec = prepare_correction_inputs(seqdb, aln, n, corr_reads_ry_seq_id,
                                        seq_id_thr)
    lens_all = seqdb.lengths.astype(np.int64)

    # per-query width requirement: own length and the longest target in
    # the surviving stack
    wq = lens_all.copy()
    kp = np.nonzero(rec["rec_keep_pre"])[0]
    if len(kp):
        np.maximum.at(wq, rec["rec_q"][kp],
                      lens_all[rec["rec_t_row"][kp] % n])

    total_len = int(seqdb.lengths.sum())
    out_flat = seqdb.data[:total_len].copy()
    offsets = seqdb.offsets.astype(np.int64)
    heavy_all: list[np.ndarray] = []

    # queries containing any non-ACGT or lowercase character take the
    # host oracle: the device path's 2-bit pull is exact only when the
    # unchanged positions round-trip through ACGT[obs] == original byte
    from .window_cuda import has_non_acgt_flags
    done_q = has_non_acgt_flags(seqdb).copy()
    if done_q.any():
        heavy_all.append(np.nonzero(done_q)[0].astype(np.int64))
    planes_sink = None
    non_shared_lvl_ran = False
    defer_list: list | None = [] if defer else None
    wtab = correction_wtab(damage)
    for lvl in CORR_LEN_LEVELS:
        if done_q.all():
            break
        in_lvl = ~done_q & (wq <= lvl)
        done_q |= in_lvl
        if not in_lvl.any():
            continue
        rows = np.nonzero(rec["rec_keep_pre"]
                          & in_lvl[rec["rec_q"]])[0]
        qs_lvl = np.nonzero(in_lvl)[0]
        shared_lvl = lvl == CORR_LEN_LEVELS[0] and planes is not None \
            and planes["sym"].shape[1] <= bucket_len(lvl)
        if shared_lvl:
            pl_b, len_b = planes, np.asarray(lengths)
            qid_of = np.arange(n, dtype=np.int64)
            q_lvl = rec["rec_q"][rows]
            t_row_lvl = rec["rec_t_row"][rows]
            ext_lvl = seqdb.ext
            n_lvl = n
        else:
            sub = np.unique(np.concatenate(
                [qs_lvl, rec["rec_t_row"][rows] % n]))
            remap = np.full(n, -1, dtype=np.int64)
            remap[sub] = np.arange(len(sub))
            cap = bucket_len(min(lvl, int(wq[qs_lvl].max())))
            pl_b, len_b = device_planes(seqdb, max_len=cap, ids=sub,
                                        device=dev)
            n_lvl = len(sub)
            qid_of = sub.astype(np.int64)
            q_lvl = remap[rec["rec_q"][rows]]
            tr = rec["rec_t_row"][rows]
            t_row_lvl = remap[tr % n] + np.where(tr >= n, n_lvl, 0)
            ext_lvl = seqdb.ext[sub]
        if not shared_lvl:
            non_shared_lvl_ran = True
        sink = {} if (return_planes and shared_lvl) else None
        heavy = _run_correction_level(
            pl_b, len_b, rec, rows, q_lvl, t_row_lvl, ext_lvl,
            lens_all[rec["rec_t_row"][rows] % n], n_lvl, wtab,
            out_flat, offsets, qid_of, lens_all, sink=sink,
            defer_list=defer_list)
        if len(heavy):
            heavy_all.append(np.asarray(heavy, dtype=np.int64))
        if sink is not None and sink:
            planes_sink = sink

    rest = np.nonzero(~done_q)[0]
    if len(rest):
        heavy_all.append(rest.astype(np.int64))

    # queries beyond the device levels or with record stacks exceeding
    # the block's record tile run through the per-query host oracle
    # (rare: very long contigs / deep-coverage stacks; exact)
    heavy = np.unique(np.concatenate(heavy_all)) if heavy_all \
        else np.zeros(0, np.int64)
    coverage_add("correction", n - len(heavy), len(heavy))
    if len(heavy):
        # make the host routing visible (device-coverage telemetry)
        log_info(f"correction: {n - len(heavy)}/{n} queries on device, "
                 f"{len(heavy)} via host oracle")

    def _finish() -> SeqDB:
        for fn in (defer_list or ()):
            fn()                       # deferred pulls -> out_flat
        if len(heavy):
            from ..aligndb import AlnDB
            from ..stages.correction import correction_per_query
            key2qi = {int(k): i for i, k in enumerate(aln.qkeys)}
            sel_q = [key2qi[int(seqdb.keys[qid])] for qid in heavy
                     if int(seqdb.keys[qid]) in key2qi]
            row_idx = np.concatenate(
                [np.arange(aln.starts[qi], aln.starts[qi + 1])
                 for qi in sel_q]) if sel_q else np.zeros(0, np.int64)
            grp = np.array([aln.starts[qi + 1] - aln.starts[qi]
                            for qi in sel_q], dtype=np.int64)
            aln_h = AlnDB.from_arrays(
                aln.qkey[row_idx], aln.qkeys[sel_q],
                np.concatenate([[0], np.cumsum(grp)]),
                **{k_: v[row_idx] for k_, v in aln.cols.items()})
            corr_h = correction_per_query(seqdb, aln_h, damage,
                                          corr_reads_ry_seq_id,
                                          seq_id_thr)
            for qid in heavy:
                o = offsets[qid]
                Lq = int(seqdb.lengths[qid])
                out_flat[o:o + Lq] = corr_h.seq_bytes(int(qid))
        return SeqDB.from_flat(out_flat, seqdb.lengths.copy(),
                               keys=seqdb.keys.copy(),
                               ext=seqdb.ext.copy(),
                               headers=seqdb.headers)

    # corrected shared planes, derived on device when every corrected
    # query ran in the shared level-0 blocks (no heavy/host-corrected
    # rows that would leave stale plane rows); `None` tells the caller
    # to fall back to a fresh pack+upload.  Derivation dispatches BEFORE
    # the deferred pulls execute, so in defer mode the planes are
    # available while the correction output still streams to the host.
    shared_out = None
    if return_planes and planes is not None and len(heavy) == 0 \
            and not non_shared_lvl_ran:
        if planes_sink is not None:
            blocks = planes_sink["blocks"]
            g = planes_sink["g"]
            slot_pos = np.nonzero(blocks["slot_valid"])[0]
            src = np.full(n, -1, dtype=np.int32)
            src[blocks["slot_qid"][slot_pos]] = \
                _slot_row_index(slot_pos, g).astype(np.int32)
            with subtimer("corr.derive_planes"):
                derived = derive_corrected_planes(
                    planes["sym"], planes["len"],
                    planes_sink["dev_out"], to_device(src, dev))
            shared_out = {"planes": derived, "lengths": lengths}
        elif kp.size == 0:
            # nothing survived the pre-filters anywhere: correction was
            # the identity, the input planes are still exact
            shared_out = {"planes": planes, "lengths": lengths}
    if defer:
        return (_finish, shared_out) if return_planes else _finish
    out_db = _finish()
    return (out_db, shared_out) if return_planes else out_db
