"""Native host runtime: C++ implementations of host-side hot loops
(k-mer selection walk, per-pair overlap scoring, correction coverage
accumulation), compiled on first use and loaded via ctypes.

The CUDA kernels (ops/*_cuda.py) handle the dense math on the card; this
layer runs the orchestration loops the reference implements in OpenMP
C++.  The library is built with g++ into build/torch_kernels/ at the
repository root, keyed by a hash of the sources, under a timeout; a
failed build raises (there is no slow NumPy substitute on this path).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import build_shared_library

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["kmer_select.cpp", "host_kernels.cpp", "prepass.cpp",
            "kmer_pairs.cpp", "banded.cpp", "linclust_kernels.cpp",
            "greedy.cpp", "ksw_wrap.cpp"]
BUILD_TIMEOUT_S = 600
_LOCK = threading.Lock()
_LIB = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def build():
    """Compile (or find cached) the host library; returns the BuildResult
    (path, seconds, cached).  Raises RuntimeError on failure."""
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    return build_shared_library(
        "carpedeam_native", srcs,
        lambda out: ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", "-fopenmp", *srcs, "-o", out],
        timeout_s=BUILD_TIMEOUT_S)


def _as(arr, dtype, ptr):
    return np.ascontiguousarray(arr, dtype=dtype).ctypes.data_as(ptr)


# Grow-only buffer pool for the per-iteration hot-path scratch arrays.
# First-touch page faults cost ~14s/GB on the measurement VM, so
# re-allocating multi-GB buffers every assembly iteration dominated
# large-scale runs; pooled buffers fault once and stay warm.  CONTRACT:
# a pooled buffer is valid only until the same pool name is requested
# again — callers must not hold pooled views across stage calls.
_POOL: dict[str, np.ndarray] = {}


def pool_array(name: str, n: int, dtype) -> np.ndarray:
    n = int(n)
    a = _POOL.get(name)
    if a is None or a.dtype != np.dtype(dtype) or len(a) < n:
        a = np.zeros(max(int(n * 1.25) + 16, 1024), dtype=dtype)
        _POOL[name] = a
    return a[:n]


def get_lib():
    """Returns the loaded native library, building it on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = build().path
        lib = ctypes.CDLL(path)
        lib.select_kmers_batch.argtypes = [_u64p, _u16p, _i64p, _i64p,
                                           ctypes.c_int64, _u8p]
        lib.select_kmers_batch.restype = None
        lib.score_pairs.argtypes = [_u8p, _i64p, _i64p, _i32p, _i32p, _i32p,
                                    _u8p, ctypes.c_int64,
                                    _i32p, _i32p, _i32p, _i32p, _i32p,
                                    _i32p, _i32p]
        lib.score_pairs.restype = None
        lib.cyclecheck_batch.argtypes = [_u8p, _i64p, _i64p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         _i32p]
        lib.cyclecheck_batch.restype = None
        _u32p = ctypes.POINTER(ctypes.c_uint32)
        _f32 = ctypes.c_float
        _f64p = ctypes.POINTER(ctypes.c_double)
        lib.contig_prepass.argtypes = [
            _u8p, _i64p, _i64p, ctypes.c_int64,
            _i32p, _i32p, _u8p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u8p, ctypes.c_int64, _f32, _f32, _f64p, _f64p,
            _i64p, _i64p, _u8p, _f64p, _f64p, _i64p, _f64p]
        lib.contig_prepass.restype = None
        _ldp = ctypes.POINTER(ctypes.c_longdouble)
        lib.read_prepass.argtypes = [
            _u8p, _i64p, _i64p, ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u8p, _u8p, ctypes.c_int64, _f32, _f64p,
            _i64p, _i64p, _u8p, _f64p, _f64p,
            _i64p, _u8p, _u8p, _ldp, _i64p]
        lib.read_prepass.restype = None
        lib.lik_ratio_ld.argtypes = [_f64p, _ldp, ctypes.c_int64, _f64p]
        lib.lik_ratio_ld.restype = None
        lib.correction_groups.argtypes = [
            _u8p, _i64p, _i64p, _u8p, ctypes.c_int64,
            _i64p, _i32p, _i32p, _u8p, _i32p, _i32p, _i32p, _u8p, _i32p,
            _f64p, _f64p, _f64p, _u8p]
        lib.correction_groups.restype = None
        lib.kmer_extract.argtypes = [
            _u8p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int64, _f32, _i64p,
            _u64p, _i32p, _u16p, _i64p]
        lib.kmer_extract.restype = None
        lib.kmer_compact.argtypes = [
            _u64p, _i32p, _u16p, _i64p, _i64p, _i64p, ctypes.c_int64,
            _i64p, _u64p, _i64p, _i32p, _i32p, _u16p]
        lib.kmer_compact.restype = None
        lib.corr_unpack2_scatter.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _u8p, _i32p, _i64p, _i64p, _i64p, _u8p]
        lib.corr_unpack2_scatter.restype = None
        lib.seq_non_acgt_flags.argtypes = [_u8p, _i64p, _i64p,
                                           ctypes.c_int64, _u8p]
        lib.seq_non_acgt_flags.restype = None
        _f64 = ctypes.c_double
        lib.greedy_read_rounds.argtypes = [
            _u8p, _i64p, _i64p, _u32p, ctypes.c_int64, _i64p, _i64p,
            _i64p, _u32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _f64p, _f64p, _f64p, _f64p, _u8p, _i64p, _i64p, _f64p,
            _f64, _f64, _f64, _f64, ctypes.c_int64,
            _u8p, _i64p, _i64p]
        lib.greedy_read_rounds.restype = None
        lib.greedy_contig_rounds.argtypes = [
            _u8p, _i64p, _i64p, _u32p, ctypes.c_int64, _i64p, _i64p,
            _i64p, _u32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _f64p, _f64p, _f64p, _i64p, _u8p, _u8p,
            _f64, _f64, ctypes.c_int64,
            _u8p, _i64p, _i64p]
        lib.greedy_contig_rounds.restype = None
        lib.wrapped_banded_align.argtypes = [
            _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i64p]
        lib.wrapped_banded_align.restype = ctypes.c_int64
        _u32p2 = ctypes.POINTER(ctypes.c_uint32)
        lib.kmermatcher_scan.argtypes = [
            _u64p, _i64p, _i32p, _i32p, ctypes.c_int64, _u32p2,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            _u32p2, _u32p2, _i32p, _i32p, _i64p, _i64p, _i64p]
        lib.kmermatcher_scan.restype = ctypes.c_int64
        lib.kmer_emit_pairs.argtypes = [
            _u64p, _i64p, _i32p, _i32p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            _u64p, _u32p2, _u8p]
        lib.kmer_emit_pairs.restype = ctypes.c_int64
        lib.kmer_pairs_to_pref.argtypes = [
            _u64p, _u32p2, _u8p, ctypes.c_int64, _u32p2,
            _u32p2, _u32p2, _i32p, _i32p, _i64p, _i64p, _i64p]
        lib.kmer_pairs_to_pref.restype = ctypes.c_int64
        lib.banded_align_one.argtypes = [
            _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _i64p]
        lib.banded_align_one.restype = None
        lib.linclust_wrapped_rescore.argtypes = [
            _u8p, _i64p, _i64p, _i32p, _i32p, _u16p, _u8p,
            ctypes.c_int64, _i32p]
        lib.linclust_wrapped_rescore.restype = None
        lib.linclust_align_best.argtypes = [
            _u8p, _i64p, _i64p, _i32p, _i32p, _u16p, _u8p,
            ctypes.c_int64, _i32p]
        lib.linclust_align_best.restype = None
        lib.pack_planes.argtypes = [
            _u8p, _i64p, _i64p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, _u8p, _u8p, _u8p, _u8p]
        lib.pack_planes.restype = None
        _LIB = lib
        return _LIB


def select_kmers_batch(masked_kmers: np.ndarray, hashes: np.ndarray,
                       seq_offsets: np.ndarray,
                       kmer_considered: np.ndarray) -> np.ndarray:
    """Batched selection walk; returns the bool mask."""
    lib = get_lib()
    selected = np.zeros(len(masked_kmers), dtype=np.uint8)
    lib.select_kmers_batch(
        _as(masked_kmers, np.uint64, _u64p), _as(hashes, np.uint16, _u16p),
        _as(seq_offsets, np.int64, _i64p),
        _as(kmer_considered, np.int64, _i64p),
        len(kmer_considered), selected.ctypes.data_as(_u8p))
    return selected.astype(bool)


def score_pairs(data, offsets, lengths, qid, tid, diag,
                is_rev) -> dict:
    """End-to-end ungapped scoring of all pairs; returns the raw arrays
    dict that stages.rescorediagonal.assemble_alndb reads."""
    lib = get_lib()
    n = len(qid)
    out = {k: pool_array("sp." + k, n, np.int32)
           for k in ("score", "qstart", "qend", "tstart", "tend",
                     "aln_len", "id_cnt")}
    lib.score_pairs(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p), _as(qid, np.int32, _i32p),
        _as(tid, np.int32, _i32p), _as(diag, np.int32, _i32p),
        _as(is_rev, np.uint8, _u8p), n,
        *(out[k].ctypes.data_as(_i32p)
          for k in ("score", "qstart", "qend", "tstart", "tend",
                    "aln_len", "id_cnt")))
    return out


def cyclecheck_batch(data, offsets, lengths, k: int,
                     max_seq_len: int) -> np.ndarray:
    """Per-sequence circular-contig split diagonal (0 = not circular)."""
    lib = get_lib()
    n = len(lengths)
    split = np.zeros(n, dtype=np.int32)
    lib.cyclecheck_batch(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p), n, k, max_seq_len,
        split.ctypes.data_as(_i32p))
    return split


def contig_prepass(data, offsets, lengths, qid, tid, is_rev, qs, qe, ts, te,
                   alen, not_identity, merge_thr: float,
                   ry_thr: float, lik5_f, lik5_r) -> dict:
    """Per-record contig-merge pre-pass (pass-B identities, candidate gate,
    consensus update, ancientMatchCount); returns an arrays dict."""
    lib = get_lib()
    n = len(qid)
    _f64p = ctypes.POINTER(ctypes.c_double)
    out = {
        "idc": pool_array("cp.idc", n, np.int64),
        "ryc": pool_array("cp.ryc", n, np.int64),
        "cand": pool_array("cp.cand", n, np.uint8),
        "seq_id": pool_array("cp.seq_id", n, np.float64),
        "ry_seq_id": pool_array("cp.ry_seq_id", n, np.float64),
        "aln_len_cons": pool_array("cp.alc", n, np.int64),
        "deam_match": pool_array("cp.deam", n, np.float64),
    }
    lib.contig_prepass(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p), len(data),
        _as(qid, np.int32, _i32p), _as(tid, np.int32, _i32p),
        _as(is_rev, np.uint8, _u8p),
        _as(qs, np.int32, _i32p), _as(qe, np.int32, _i32p),
        _as(ts, np.int32, _i32p), _as(te, np.int32, _i32p),
        _as(alen, np.int32, _i32p), _as(not_identity, np.uint8, _u8p), n,
        ctypes.c_float(merge_thr), ctypes.c_float(ry_thr),
        _as(lik5_f, np.float64, _f64p), _as(lik5_r, np.float64, _f64p),
        out["idc"].ctypes.data_as(_i64p), out["ryc"].ctypes.data_as(_i64p),
        out["cand"].ctypes.data_as(_u8p),
        out["seq_id"].ctypes.data_as(_f64p),
        out["ry_seq_id"].ctypes.data_as(_f64p),
        out["aln_len_cons"].ctypes.data_as(_i64p),
        out["deam_match"].ctypes.data_as(_f64p))
    out["cand"] = out["cand"].astype(bool)
    return out


def read_prepass(data, offsets, lengths, qid, tid, qs, qe, ts, te, alen,
                 terminal, ext_t, seq_id_thr: float, logm) -> dict:
    """Per-record read-phase pre-pass (pass B/C, consensus update,
    likelihood columns); returns an arrays dict."""
    lib = get_lib()
    n = len(qid)
    _f64p = ctypes.POINTER(ctypes.c_double)
    out = {
        "idc": pool_array("rp.idc", n, np.int64),
        "ryc": pool_array("rp.ryc", n, np.int64),
        "cand": pool_array("rp.cand", n, np.uint8),
        "seq_id": pool_array("rp.seq_id", n, np.float64),
        "ry_seq_id": pool_array("rp.ry_seq_id", n, np.float64),
        "cons_total": pool_array("rp.cons_total", n, np.int64),
        "cons_valid": pool_array("rp.cons_valid", n, np.uint8),
        "cons_left": pool_array("rp.cons_left", n, np.uint8),
        "lik_mod": pool_array("rp.lik_mod", n, np.longdouble),
        "aln_count": pool_array("rp.aln_count", n, np.int64),
    }
    lib.read_prepass(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p), len(data),
        _as(qid, np.int32, _i32p), _as(tid, np.int32, _i32p),
        _as(qs, np.int32, _i32p), _as(qe, np.int32, _i32p),
        _as(ts, np.int32, _i32p), _as(te, np.int32, _i32p),
        _as(alen, np.int32, _i32p), _as(terminal, np.uint8, _u8p),
        _as(ext_t, np.uint8, _u8p), n, ctypes.c_float(seq_id_thr),
        _as(logm, np.float64, _f64p),
        out["idc"].ctypes.data_as(_i64p), out["ryc"].ctypes.data_as(_i64p),
        out["cand"].ctypes.data_as(_u8p),
        out["seq_id"].ctypes.data_as(_f64p),
        out["ry_seq_id"].ctypes.data_as(_f64p),
        out["cons_total"].ctypes.data_as(_i64p),
        out["cons_valid"].ctypes.data_as(_u8p),
        out["cons_left"].ctypes.data_as(_u8p),
        out["lik_mod"].ctypes.data_as(ctypes.POINTER(ctypes.c_longdouble)),
        out["aln_count"].ctypes.data_as(_i64p))
    out["cand"] = out["cand"].astype(bool)
    out["cons_valid"] = out["cons_valid"].astype(bool)
    out["cons_left"] = out["cons_left"].astype(bool)
    return out


def lik_ratio_ld(rand_aln: np.ndarray, lik_ld: np.ndarray) -> np.ndarray:
    """sRatio = double(1.0L/(1.0L+expl(randAln - likMod))) per record with
    glibc expl (the reference's nuclassembleUtil.cpp:340; numpy's longdouble
    exp differs in the last ulp).  lik_ld includes the excess penalty."""
    lib = get_lib()
    n = len(lik_ld)
    _f64p = ctypes.POINTER(ctypes.c_double)
    out = np.empty(n, dtype=np.float64)
    ra = np.ascontiguousarray(rand_aln, dtype=np.float64)
    ld = np.ascontiguousarray(lik_ld, dtype=np.longdouble)
    lib.lik_ratio_ld(ra.ctypes.data_as(_f64p),
                     ld.ctypes.data_as(ctypes.POINTER(ctypes.c_longdouble)),
                     n, out.ctypes.data_as(_f64p))
    return out


def correction_groups(data, offsets, lengths, ext, rec_starts, group_q,
                      rec_t, rec_is_rev, rec_qstart, rec_tstart, rec_alen,
                      rec_keep_pre, rec_ry_smin, log_err, log_deam_f,
                      log_deam_r) -> np.ndarray:
    """Whole-stage correction per query group; returns the corrected flat
    byte array (passthrough positions keep the input bytes)."""
    lib = get_lib()
    _f64p = ctypes.POINTER(ctypes.c_double)
    out = np.ascontiguousarray(data, dtype=np.uint8).copy()
    lib.correction_groups(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p), _as(ext, np.uint8, _u8p),
        len(group_q),
        _as(rec_starts, np.int64, _i64p), _as(group_q, np.int32, _i32p),
        _as(rec_t, np.int32, _i32p), _as(rec_is_rev, np.uint8, _u8p),
        _as(rec_qstart, np.int32, _i32p), _as(rec_tstart, np.int32, _i32p),
        _as(rec_alen, np.int32, _i32p), _as(rec_keep_pre, np.uint8, _u8p),
        _as(rec_ry_smin, np.int32, _i32p),
        _as(log_err, np.float64, _f64p),
        _as(log_deam_f, np.float64, _f64p),
        _as(log_deam_r, np.float64, _f64p),
        out.ctypes.data_as(_u8p))
    return out


def kmer_extract(data, offsets, lengths, k: int, seed: int,
                 kmers_per_sequence: int, scale: float) -> dict:
    """Whole-DB k-mer extraction + selection (identity entry first per
    sequence); returns the compacted entry arrays dict."""
    lib = get_lib()
    n_seqs = len(lengths)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    cap = np.maximum(lengths - k + 1, 0) + 1
    out_offsets = np.concatenate([[0], np.cumsum(cap)]).astype(np.int64)
    total_cap = int(out_offsets[-1])
    kmer_o = pool_array("ke.kmer_o", total_cap, np.uint64)
    pos_o = pool_array("ke.pos_o", total_cap, np.int32)
    h16_o = pool_array("ke.h16_o", total_cap, np.uint16)
    count_o = pool_array("ke.count_o", n_seqs, np.int64)
    lib.kmer_extract(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        lengths.ctypes.data_as(_i64p), n_seqs, k, ctypes.c_uint64(seed),
        kmers_per_sequence, ctypes.c_float(scale),
        out_offsets.ctypes.data_as(_i64p),
        kmer_o.ctypes.data_as(_u64p), pos_o.ctypes.data_as(_i32p),
        h16_o.ctypes.data_as(_u16p), count_o.ctypes.data_as(_i64p))
    # compact the per-sequence regions (native parallel memcpy)
    dst_offsets = np.concatenate([[0], np.cumsum(count_o)]).astype(np.int64)
    n_total = int(dst_offsets[-1])
    kmer_c = pool_array("ke.kmer_c", n_total, np.uint64)
    id_c = pool_array("ke.id_c", n_total, np.int64)
    pos_c = pool_array("ke.pos_c", n_total, np.int32)
    len_c = pool_array("ke.len_c", n_total, np.int32)
    h16_c = pool_array("ke.h16_c", n_total, np.uint16)
    lib.kmer_compact(
        kmer_o.ctypes.data_as(_u64p), pos_o.ctypes.data_as(_i32p),
        h16_o.ctypes.data_as(_u16p), out_offsets.ctypes.data_as(_i64p),
        count_o.ctypes.data_as(_i64p), lengths.ctypes.data_as(_i64p),
        n_seqs, dst_offsets.ctypes.data_as(_i64p),
        kmer_c.ctypes.data_as(_u64p), id_c.ctypes.data_as(_i64p),
        pos_c.ctypes.data_as(_i32p), len_c.ctypes.data_as(_i32p),
        h16_c.ctypes.data_as(_u16p))
    return {
        "kmer": kmer_c,
        "id": id_c,
        "pos": pos_c,
        "seq_len": len_c,
        "h16": h16_c,
    }


def kmermatcher_scan(kmer, ids, pos, seq_len, keys,
                     include_only_extendable: bool, cov_mode: int,
                     cov_thr: float) -> tuple:
    """Fused sort + assignGroup + pair sort + writeKmerMatcherResult scan
    over raw (unsorted) k-mer entries; returns (qkey, tkey, score, diag,
    group_row_start, group_centre) arrays."""
    lib = get_lib()
    _u32p = ctypes.POINTER(ctypes.c_uint32)
    n = len(kmer)
    cap = 2 * n + 2
    qkey = pool_array("ks.qkey", cap, np.uint32)
    tkey = pool_array("ks.tkey", cap, np.uint32)
    score = pool_array("ks.score", cap, np.int32)
    diag = pool_array("ks.diag", cap, np.int32)
    grs = pool_array("ks.grs", n + 1, np.int64)
    gc = pool_array("ks.gc", n + 1, np.int64)
    ng = np.zeros(1, dtype=np.int64)
    n_rows = lib.kmermatcher_scan(
        _as(kmer, np.uint64, _u64p), _as(ids, np.int64, _i64p),
        _as(pos, np.int32, _i32p), _as(seq_len, np.int32, _i32p), n,
        _as(keys, np.uint32, _u32p),
        1 if include_only_extendable else 0, cov_mode,
        ctypes.c_float(cov_thr),
        qkey.ctypes.data_as(_u32p), tkey.ctypes.data_as(_u32p),
        score.ctypes.data_as(_i32p), diag.ctypes.data_as(_i32p),
        grs.ctypes.data_as(_i64p), gc.ctypes.data_as(_i64p),
        ng.ctypes.data_as(_i64p))
    g = int(ng[0])
    return (qkey[:n_rows], tkey[:n_rows], score[:n_rows], diag[:n_rows],
            grs[:g], gc[:g])


def kmer_emit_pairs(ent: dict, include_only_extendable: bool,
                    cov_mode: int = 0, cov_thr: float = 0.0) -> tuple:
    """Phase 1 of the kmermatcher scan (native/kmer_pairs.cpp): entry
    table -> (pk1, pk2, fwd) pair stream, the same for any order of the
    same entries."""
    lib = get_lib()
    _u32p = ctypes.POINTER(ctypes.c_uint32)
    n = len(ent["kmer"])
    pk1 = np.zeros(n, dtype=np.uint64)
    pk2 = np.zeros(n, dtype=np.uint32)
    fwd = np.zeros(n, dtype=np.uint8)
    n_pairs = lib.kmer_emit_pairs(
        _as(ent["kmer"], np.uint64, _u64p), _as(ent["id"], np.int64, _i64p),
        _as(ent["pos"], np.int32, _i32p),
        _as(ent["seq_len"], np.int32, _i32p), n,
        1 if include_only_extendable else 0, int(cov_mode),
        ctypes.c_float(cov_thr),
        pk1.ctypes.data_as(_u64p), pk2.ctypes.data_as(_u32p),
        fwd.ctypes.data_as(_u8p))
    return pk1[:n_pairs], pk2[:n_pairs], fwd[:n_pairs]


def kmer_pairs_to_pref(pk1, pk2, fwd, keys) -> tuple:
    """Phase 2: pair stream -> (qkey, tkey, score, diag, group_row_start,
    group_centre), the result shape of kmermatcher_scan.  The pair sort is
    stable, so the given order breaks ties."""
    lib = get_lib()
    _u32p = ctypes.POINTER(ctypes.c_uint32)
    n_pairs = len(pk1)
    cap = 2 * n_pairs + 2
    qkey = np.zeros(cap, dtype=np.uint32)
    tkey = np.zeros(cap, dtype=np.uint32)
    score = np.zeros(cap, dtype=np.int32)
    diag = np.zeros(cap, dtype=np.int32)
    grs = np.zeros(cap, dtype=np.int64)
    gc = np.zeros(cap, dtype=np.int64)
    ng = np.zeros(1, dtype=np.int64)
    n_rows = lib.kmer_pairs_to_pref(
        _as(pk1, np.uint64, _u64p), _as(pk2, np.uint32, _u32p),
        _as(fwd, np.uint8, _u8p), n_pairs, _as(keys, np.uint32, _u32p),
        qkey.ctypes.data_as(_u32p), tkey.ctypes.data_as(_u32p),
        score.ctypes.data_as(_i32p), diag.ctypes.data_as(_i32p),
        grs.ctypes.data_as(_i64p), gc.ctypes.data_as(_i64p),
        ng.ctypes.data_as(_i64p))
    g = int(ng[0])
    return (qkey[:n_rows], tkey[:n_rows], score[:n_rows], diag[:n_rows],
            grs[:g], gc[:g])


def banded_align_one(q, t, band: int, match: int, mismatch: int,
                     gapo: int, gape: int) -> tuple:
    """Banded affine-gap alignment of one code-array pair (the Python
    oracle lives in ops/banded_align.py); returns
    (score, q_end, t_end, n_ident, aln_len)."""
    lib = get_lib()
    out = np.zeros(5, dtype=np.int64)
    lib.banded_align_one(
        _as(q, np.uint8, _u8p), len(q), _as(t, np.uint8, _u8p), len(t),
        band, match, mismatch, gapo, gape, out.ctypes.data_as(_i64p))
    return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
            int(out[4]))


def linclust_wrapped_rescore(data, offsets, lengths, qid, tid, diag_u,
                             is_rev) -> np.ndarray:
    """Best wrapped-hamming diagonal per prefilter pair; returns an
    (n, 3) int32 array [best_score, best_diag, valid].  Oracle: stages/linclust.py hamming_wrapped_rescore."""
    lib = get_lib()
    n = len(qid)
    out = np.zeros((n, 3), dtype=np.int32)
    lib.linclust_wrapped_rescore(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p), _as(qid, np.int32, _i32p),
        _as(tid, np.int32, _i32p), _as(diag_u, np.uint16, _u16p),
        _as(is_rev, np.uint8, _u8p), n, out.ctypes.data_as(_i32p))
    return out


def linclust_align_best(data, offsets, lengths, qid, tid, diag_u,
                        is_rev) -> np.ndarray:
    """Best end-to-end candidate diagonal per pair for the align stage;
    returns an (n, 5) int32 array [score, cand, n, ids, valid].
    Oracle: stages/linclust.py align_filter's inner candidate loop."""
    lib = get_lib()
    n = len(qid)
    out = np.zeros((n, 5), dtype=np.int32)
    lib.linclust_align_best(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p), _as(qid, np.int32, _i32p),
        _as(tid, np.int32, _i32p), _as(diag_u, np.uint16, _u16p),
        _as(is_rev, np.uint8, _u8p), n, out.ctypes.data_as(_i32p))
    return out


def corr_unpack2_scatter(packed, nb: int, g: int, max_len: int,
                        slot_valid, slot_qid, qid_of, lens_global,
                        offsets, out_flat) -> bool:
    """Un-nibble the correction kernel's packed output and scatter the
    corrected bases into out_flat IN PLACE; returns True."""
    lib = get_lib()
    lib.corr_unpack2_scatter(
        _as(packed, np.uint8, _u8p), nb, g, max_len,
        _as(np.ascontiguousarray(slot_valid, dtype=np.uint8), np.uint8,
            _u8p),
        _as(np.ascontiguousarray(slot_qid, dtype=np.int32), np.int32,
            _i32p),
        _as(np.ascontiguousarray(qid_of, dtype=np.int64), np.int64, _i64p),
        _as(np.ascontiguousarray(lens_global, dtype=np.int64), np.int64,
            _i64p),
        _as(np.ascontiguousarray(offsets, dtype=np.int64), np.int64,
            _i64p),
        out_flat.ctypes.data_as(_u8p))
    return True


def pack_planes(data, offsets, lengths, ids, max_len: int):
    """One-pass CSR -> padded planes (sym, sym_rc, code, code_rc), each
    (n, max_len) uint8.  Oracle:
    ops/planes.pack_sequences."""
    lib = get_lib()
    n = len(ids) if ids is not None else len(offsets)
    out = [np.zeros((n, max_len), dtype=np.uint8) for _ in range(4)]
    lib.pack_planes(
        _as(data, np.uint8, _u8p), _as(offsets, np.int64, _i64p),
        _as(lengths, np.int64, _i64p),
        _as(ids, np.int64, _i64p) if ids is not None else None,
        n, max_len, *(o.ctypes.data_as(_u8p) for o in out))
    return out


def greedy_read_rounds(seqdb, q_ids, row_ptr, rows, max_left, max_right,
                       logm, seq_id_thr, lik_thr, log_rand, log_excess,
                       max_seq_len):
    """Native greedy splice rounds for read-phase extension (see
    native/greedy.cpp; oracle: stages/read_assembly.py per-query loop).
    `rows` is a dict of per-candidate arrays; returns (arena, arena_off,
    out_len)."""
    import ctypes
    lib = get_lib()
    nq = len(q_ids)
    cnt = row_ptr[1:] - row_ptr[:-1]
    tl64 = rows["tl"].astype(np.int64)
    cap = np.minimum(seqdb.lengths[q_ids].astype(np.int64)
                     + np.add.reduceat(tl64, row_ptr[:-1],
                                       axis=0) * (cnt > 0),
                     max_seq_len) if len(tl64) else \
        np.minimum(seqdb.lengths[q_ids].astype(np.int64), max_seq_len)
    arena_off = np.concatenate([[0], np.cumsum(cap)]).astype(np.int64)
    arena = pool_array("gr.arena", int(arena_off[-1]), np.uint8)
    out_len = pool_array("gr.out_len", nq, np.int64)
    _f64p2 = ctypes.POINTER(ctypes.c_double)
    lib.greedy_read_rounds(
        _as(seqdb.data, np.uint8, _u8p),
        _as(seqdb.offsets, np.int64, _i64p),
        _as(seqdb.lengths, np.int64, _i64p),
        _as(seqdb.keys, np.uint32, ctypes.POINTER(ctypes.c_uint32)),
        nq, _as(q_ids, np.int64, _i64p), _as(row_ptr, np.int64, _i64p),
        _as(rows["tid"], np.int64, _i64p),
        _as(rows["tkey"], np.uint32, ctypes.POINTER(ctypes.c_uint32)),
        _as(rows["qs"], np.int32, _i32p), _as(rows["qe"], np.int32, _i32p),
        _as(rows["ts"], np.int32, _i32p), _as(rows["te"], np.int32, _i32p),
        _as(rows["tl"], np.int32, _i32p),
        _as(rows["alen"], np.int32, _i32p),
        _as(rows["seq_id"], np.float64, _f64p2),
        _as(rows["ry"], np.float64, _f64p2),
        _as(rows["sln"], np.float64, _f64p2),
        _as(rows["sratio"], np.float64, _f64p2),
        _as(rows["qok"], np.uint8, _u8p),
        _as(max_left, np.int64, _i64p), _as(max_right, np.int64, _i64p),
        _as(logm, np.float64, _f64p2),
        float(np.float32(seq_id_thr)), float(lik_thr),
        float(log_rand), float(log_excess), int(max_seq_len),
        arena.ctypes.data_as(_u8p), arena_off.ctypes.data_as(_i64p),
        out_len.ctypes.data_as(_i64p))
    return arena, arena_off, out_len


def greedy_contig_rounds(seqdb, q_ids, row_ptr, rows, merge_thr, ry_thr,
                         max_seq_len):
    """Native greedy rounds for contig-phase merging (Beta-posterior
    queue; oracle: stages/contig_merge.py per-query loop)."""
    import ctypes
    lib = get_lib()
    nq = len(q_ids)
    cnt = row_ptr[1:] - row_ptr[:-1]
    tl64 = rows["tl"].astype(np.int64)
    cap = np.minimum(seqdb.lengths[q_ids].astype(np.int64)
                     + (np.add.reduceat(tl64, row_ptr[:-1], axis=0)
                        * (cnt > 0) if len(tl64) else 0),
                     max_seq_len)
    arena_off = np.concatenate([[0], np.cumsum(cap)]).astype(np.int64)
    arena = pool_array("gc.arena", int(arena_off[-1]), np.uint8)
    out_len = pool_array("gc.out_len", nq, np.int64)
    _f64p2 = ctypes.POINTER(ctypes.c_double)
    lib.greedy_contig_rounds(
        _as(seqdb.data, np.uint8, _u8p),
        _as(seqdb.offsets, np.int64, _i64p),
        _as(seqdb.lengths, np.int64, _i64p),
        _as(seqdb.keys, np.uint32, ctypes.POINTER(ctypes.c_uint32)),
        nq, _as(q_ids, np.int64, _i64p), _as(row_ptr, np.int64, _i64p),
        _as(rows["tid"], np.int64, _i64p),
        _as(rows["tkey"], np.uint32, ctypes.POINTER(ctypes.c_uint32)),
        _as(rows["qs"], np.int32, _i32p), _as(rows["qe"], np.int32, _i32p),
        _as(rows["ts"], np.int32, _i32p), _as(rows["te"], np.int32, _i32p),
        _as(rows["tl"], np.int32, _i32p),
        _as(rows["alen"], np.int32, _i32p),
        _as(rows["seq_id"], np.float64, _f64p2),
        _as(rows["ry"], np.float64, _f64p2),
        _as(rows["deam"], np.float64, _f64p2),
        _as(rows["alc"], np.int64, _i64p),
        _as(rows["is_rev"], np.uint8, _u8p),
        _as(rows["qok"], np.uint8, _u8p),
        float(np.float32(merge_thr)), float(np.float32(ry_thr)),
        int(max_seq_len),
        arena.ctypes.data_as(_u8p), arena_off.ctypes.data_as(_i64p),
        out_len.ctypes.data_as(_i64p))
    return arena, arena_off, out_len


def seq_non_acgt_flags(seqdb):
    """Per-sequence flags (bool array): any character outside uppercase
    ACGT."""
    lib = get_lib()
    n = len(seqdb.lengths)
    flags = np.zeros(n, dtype=np.uint8)
    lib.seq_non_acgt_flags(
        _as(seqdb.data, np.uint8, _u8p),
        _as(seqdb.offsets, np.int64, _i64p),
        _as(seqdb.lengths, np.int64, _i64p), n,
        flags.ctypes.data_as(_u8p))
    return flags.astype(bool)


def wrapped_banded_align(q2codes, tcodes, diag_u, gapo=5, gape=2,
                         zdrop=40):
    """BandedNucleotideAligner::align with --wrapped-scoring, replicated
    bit-exactly over ksw2-extz semantics (native/ksw_wrap.cpp; golden:
    tools/ksw_golden.cpp vs the vendored ksw2).  Returns a dict."""
    lib = get_lib()
    out = np.zeros(8, dtype=np.int64)
    lib.wrapped_banded_align(
        _as(q2codes, np.uint8, _u8p), len(q2codes),
        _as(tcodes, np.uint8, _u8p), len(tcodes),
        int(diag_u), int(gapo), int(gape), int(zdrop),
        out.ctypes.data_as(_i64p))
    return {"score": int(out[0]), "qstart": int(out[1]),
            "qend": int(out[2]), "tstart": int(out[3]),
            "tend": int(out[4]), "aa_ids": int(out[5]),
            "aln_len": int(out[6]), "shortcut": bool(out[7])}
