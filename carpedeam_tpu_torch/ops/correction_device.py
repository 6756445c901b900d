"""`--use-device 1` correction: whole-database Bayesian polishing as
tensor programs on `device`.

Port of carpedeam_tpu/ops/correction_tpu.py: `correction_scatter` (:54),
`correction_argmax` (:96), `correction_device` (:131) and
`correction_tpu` (:219, here `correction_device_stage`); the host
record preparation is stages/correction.prepare_correction_inputs, the
same function as the JAX module's (:155).

  1. per record, the RY-identity gate as masked window reductions over
     the symbol planes;
  2. two scatter-adds of every aligned column into flat (positions x 44)
     int32 counts (forward plus reverse, and reverse only): `index_add_`
     on int32, exact and order-free;
  3. per position, the f32 likelihood of each candidate base and its
     argmax.

Threshold compares are exact integers, as in the JAX program: the RY
gate compares the match count with the host's smallest passing count,
and the C->T / G->A ratio exits are `5*count >= 2*total`.  The
likelihood is f32 (the JAX package runs without x64), its two einsums
written as separate multiplies and adds, classes in a fixed order, and
summed as term_q + term_f + term_r; only its argmax leaves the function.
The JAX program pads records and positions to reuse its compilations;
padding changes no output, so the port has none.  Records are
scattered in chunks that bound the (records x L) window tensors.

As in ops/rescore_device.py, planes narrower than the longest sequence
are not used (the JAX function's windows would be clipped to them); the
stage packs full-width planes instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import CHAR_TO_ACGT, SMOOTHING_VALUE
from ..damage import DamageModel, layer_index, seq_error_profile
from ..io.seqdb import SeqDB
from .planes import to_device
from .rescore_device import CHUNK_ELEMS, full_width_planes


def _sym_to_acgt(b):
    out = torch.zeros(b.shape, dtype=torch.int64, device=b.device)
    out = torch.where(b == ord("C"), 1, out)
    out = torch.where(b == ord("G"), 2, out)
    return torch.where(b == ord("T"), 3, out)


def _sym_to_ry(b):
    return (b == ord("C")) | (b == ord("T"))


def correction_scatter(sym2, lengths, rec_q, rec_t_row, rec_qstart,
                       rec_tstart, rec_alen, rec_is_rev, rec_keep_pre,
                       rec_ry_smin, rec_goffset, total_len: int):
    """RY filter and coverage scatter over the alignment records: flat
    (total_len * 44,) int32 count vectors (forward + reverse, reverse
    only), additive across record chunks.  Record tensors are (R,)
    integer (bool for rec_is_rev, rec_keep_pre) on the planes' device."""
    dev = sym2.device
    counts = torch.zeros(total_len * 44 + 1, dtype=torch.int32, device=dev)
    rev_counts = torch.zeros_like(counts)
    step = max(1, CHUNK_ELEMS // max(sym2.shape[1], 1))
    recs = (rec_q, rec_t_row, rec_qstart, rec_tstart, rec_alen, rec_is_rev,
            rec_keep_pre, rec_ry_smin, rec_goffset)
    for i in range(0, rec_q.shape[0], step):
        flat, use, rev = _scatter_chunk(sym2, lengths,
                                        *(r[i:i + step] for r in recs),
                                        total_len)
        counts.index_add_(0, flat, use)
        rev_counts.index_add_(0, flat, rev)
    return counts[:-1], rev_counts[:-1]


def _scatter_chunk(sym2, lengths, rec_q, rec_t_row, rec_qstart, rec_tstart,
                   rec_alen, rec_is_rev, rec_keep_pre, rec_ry_smin,
                   rec_goffset, total_len: int):
    """(flat slot, weight, reverse weight) of every column of a chunk of
    records (carpedeam_tpu/ops/correction_tpu.py:54-93, step by step);
    unused columns go to the dump slot total_len * 44."""
    max_len = sym2.shape[1]
    pos = torch.arange(max_len, dtype=torch.int64, device=sym2.device)[None]
    rec_qstart = rec_qstart.to(torch.int64)
    rec_tstart = rec_tstart.to(torch.int64)
    rec_t_row = rec_t_row.to(torch.int64)
    in_win = pos < rec_alen.to(torch.int64)[:, None]

    t_win = torch.gather(sym2[rec_t_row], 1,
                         torch.clamp(rec_tstart[:, None] + pos, 0,
                                     max_len - 1))
    q_win = torch.gather(sym2[rec_q.to(torch.int64)], 1,
                         torch.clamp(rec_qstart[:, None] + pos, 0,
                                     max_len - 1))
    ry_match = (_sym_to_ry(q_win) == _sym_to_ry(t_win)) & in_win
    keep = rec_keep_pre & (ry_match.sum(dim=1) >= rec_ry_smin)

    g_pos = rec_goffset.to(torch.int64)[:, None] + rec_qstart[:, None] + pos
    t_base = _sym_to_acgt(t_win)
    tlen_of = lengths.to(torch.int64)[rec_t_row % lengths.shape[0]]
    t_real = rec_tstart[:, None] + pos
    layers = torch.where(t_real < 5, t_real, 5)
    from_end = t_real - (tlen_of[:, None] - 5)
    layers = torch.where(from_end >= 0, 6 + from_end, layers)

    use = in_win & keep[:, None]
    dump = total_len * 44
    flat = g_pos * 44 + t_base * 11 + layers
    # the JAX scatter drops an index outside the vector; here it goes to
    # the dump slot with the unused columns
    flat = torch.where(use & (flat >= 0) & (flat < dump), flat, dump)
    rev = use & rec_is_rev[:, None]
    return (flat.reshape(-1), use.to(torch.int32).reshape(-1),
            rev.to(torch.int32).reshape(-1))


def correction_argmax(counts, rev_counts, obs, own_layer, was_ext_pos,
                      log_err, log_deam_f, log_deam_r, log_raw_deam_f):
    """Per-position Bayesian argmax over the (n_pos, 4, 11) coverage
    stacks (carpedeam_tpu/ops/correction_tpu.py:96).  log_err (4, 4),
    log_deam_f / log_deam_r (11, 4, 4) and log_raw_deam_f (11, 4, 4) =
    log(max(raw forward damage, SMOOTHING_VALUE)) are f32 tables.
    Returns (corrected base (n_pos,), total coverage (n_pos,))."""
    counts = counts.reshape(-1, 4, 11)
    rev_counts = rev_counts.reshape(-1, 4, 11)
    base_covs = counts.sum(dim=2)
    tot = base_covs.sum(dim=1)
    obs = obs.to(torch.int64)

    log_q_err = log_err[:, obs].T
    log_q_dam = log_raw_deam_f[own_layer.to(torch.int64)[:, None],
                               torch.arange(4, device=obs.device)[None, :],
                               obs[:, None]]
    log_q = torch.where(was_ext_pos[:, None], log_q_err, log_q_dam)

    # term_obs (sum of count*log_t) is the same for every candidate base
    # and cannot change the argmax (the JAX program drops it too)
    f32 = torch.float32
    fwd_minus = (counts - rev_counts).to(f32)
    rev_f = rev_counts.to(f32)
    term_q = tot[:, None].to(f32) * log_q
    term_f = torch.zeros_like(term_q)
    term_r = torch.zeros_like(term_q)
    for t in range(4):
        for layer in range(11):
            term_f = term_f + fwd_minus[:, t, layer, None] \
                * log_deam_f[layer, :, t][None, :]
            term_r = term_r + rev_f[:, t, layer, None] \
                * log_deam_r[layer, :, t][None, :]
    lik = term_q + term_f + term_r
    new_base = torch.argmax(lik, dim=1)

    # c/t >= 0.4 in the oracle's f64 semantics == an exact rational
    # compare (counts are exact in f64; f64(0.4) > 2/5)
    ratio_exit = (~was_ext_pos) & ((5 * base_covs[:, 3] >= 2 * tot)
                                   | (5 * base_covs[:, 0] >= 2 * tot))
    corrected = torch.where(ratio_exit, obs, new_base)
    return corrected, tot


def correction_device(sym2, lengths, rec, obs, own_layer, was_ext_pos,
                      tables, total_len: int):
    """The fused stage (carpedeam_tpu/ops/correction_tpu.py:131): rec the
    record tensors of prepare_correction_inputs, tables the f32 tensors
    of `correction_tables`.  Returns (corrected base, total coverage) per
    position."""
    counts, rev_counts = correction_scatter(
        sym2, lengths, rec["rec_q"], rec["rec_t_row"], rec["rec_qstart"],
        rec["rec_tstart"], rec["rec_alen"], rec["rec_is_rev"],
        rec["rec_keep_pre"], rec["rec_ry_smin"], rec["rec_goffset"],
        total_len)
    return correction_argmax(counts, rev_counts, obs, own_layer,
                             was_ext_pos, *tables)


def correction_tables(damage: DamageModel) -> tuple[np.ndarray, ...]:
    """The f32 tables of correction_argmax, as the JAX package hands
    them to its program (f64 logs cast to f32; the raw forward table cast
    to f32, then its log taken in f32)."""
    f32 = np.float32
    log_err = np.log(seq_error_profile(0.01)).astype(f32)
    log_f = np.log(np.maximum(damage.fwd, SMOOTHING_VALUE)).astype(f32)
    log_r = np.log(np.maximum(damage.rev, SMOOTHING_VALUE)).astype(f32)
    log_raw = np.log(np.maximum(damage.fwd.astype(f32), f32(SMOOTHING_VALUE)))
    return log_err, log_f, log_r, log_raw


def correction_device_stage(seqdb: SeqDB, aln, damage: DamageModel,
                            corr_reads_ry_seq_id: float, seq_id_thr: float,
                            planes=None, lengths=None,
                            device="cuda") -> SeqDB:
    """The `--use-device 1` drop-in for stages.correction.correction:
    the scatter and the argmax run on `device` (the planes' device when
    planes are given); positions with total coverage <= 1 keep their
    base."""
    from ..stages.correction import prepare_correction_inputs
    from ..utils import coverage_add

    planes, lengths = full_width_planes(seqdb, planes, lengths, device)
    dev = planes["sym"].device
    n = len(seqdb)
    total_len = int(seqdb.lengths.sum())
    rec = prepare_correction_inputs(seqdb, aln, n, corr_reads_ry_seq_id,
                                    seq_id_thr)
    rec_d = {k: to_device(v, dev) for k, v in rec.items()}

    obs, own_layer, was_ext_pos = position_inputs(seqdb)
    corrected, tot = correction_device(
        planes["sym"], to_device(np.asarray(lengths), dev), rec_d,
        to_device(obs, dev), to_device(own_layer, dev),
        to_device(was_ext_pos, dev),
        tuple(to_device(t, dev) for t in correction_tables(damage)),
        total_len)
    coverage_add("correction", n, 0)
    return corrected_db(seqdb, corrected.cpu().numpy(), tot.cpu().numpy())


def position_inputs(seqdb: SeqDB) -> tuple[np.ndarray, ...]:
    """Per-position (obs, own_layer, was_ext_pos) over the flat data,
    records in order (the rec_goffset of a query is its offset there)."""
    lens = seqdb.lengths.astype(np.int64)
    total_len = int(lens.sum())
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    pos_in_seq = np.arange(total_len) - np.repeat(starts, lens)
    obs = CHAR_TO_ACGT[seqdb.data[:total_len]].astype(np.int64)
    own_layer = layer_index(pos_in_seq, np.repeat(lens, lens))
    return obs, own_layer, np.repeat(seqdb.ext, lens)


def corrected_db(seqdb: SeqDB, corrected: np.ndarray,
                 tot: np.ndarray) -> SeqDB:
    """The corrected SeqDB: each position's argmax base, or its own base
    where its total coverage is <= 1."""
    total_len = int(seqdb.lengths.sum())
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out_flat = np.where(tot <= 1, seqdb.data[:total_len], acgt[corrected])
    return SeqDB.from_flat(out_flat, seqdb.lengths.copy(),
                           keys=seqdb.keys.copy(), ext=seqdb.ext.copy(),
                           headers=seqdb.headers)
