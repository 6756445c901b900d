"""Per-record alignment-window identity counts on the card (kernel:
csrc/window.cu), the read-phase extension's pass B.

Port of carpedeam_tpu/ops/window_pallas.py:45-170.  For each record the
target row is read in the query frame and the exact-character and RY
identity counts are taken over [qstart, qstart + win).  The stacked
planes fold non-ACGT characters to 'X' on the rc rows and case-fold the
forward rows, so callers recompute records touching sequences with
characters outside uppercase ACGT on the host (`has_non_acgt_flags`).
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import KERNELS
from .planes import HostCopy, to_device

WINDOW = KERNELS["window_identity"]


def check_record_inputs(sym2, rows, scal, ncols):
    """Validate the (plane, row indices, scalars) inputs of the per-record
    window kernels; raise on anything the kernels do not take (on the
    card also a plane or scalar array off a 16-byte boundary)."""
    dev = sym2.device
    if sym2.dtype != torch.uint8 or sym2.dim() != 2:
        raise TypeError("sym2 must be a (2N, L) uint8 plane")
    n = rows[0].shape[0]
    for t in (*rows, scal):
        if t.device != dev:
            raise ValueError(f"input on {t.device}, sym2 on {dev}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("row indices and scalars must be contiguous "
                            "int32")
        if t.shape[0] != n:
            raise ValueError("record arrays differ in length")
    if scal.dim() != 2 or scal.shape[1] != ncols:
        raise ValueError(f"scal must be (n, {ncols}) int32")
    if not sym2.is_contiguous():
        raise ValueError("sym2 must be contiguous")
    if dev.type == "cuda" and (sym2.data_ptr() % 16 or scal.data_ptr() % 16):
        raise ValueError("sym2 and scal must be 16-byte aligned (the kernels "
                         "read them in aligned 16-byte words)")


def window_identity(sym2: torch.Tensor, qrow: torch.Tensor,
                    trow: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """(n, 2) int32 (idc, ryc) per record: query plane row qrow, target
    plane row trow, scal (n, 4) int32 = (qstart, tstart, win, 0)."""
    check_record_inputs(sym2, (qrow, trow), scal, 4)
    if sym2.device.type == "cpu":
        return window_identity_reference(sym2, qrow, trow, scal)
    out = torch.empty((qrow.shape[0], 2), dtype=torch.int32,
                      device=sym2.device)
    WINDOW.launch(sym2.data_ptr(), sym2.shape[1], qrow.data_ptr(),
                  trow.data_ptr(), scal.data_ptr(), qrow.shape[0],
                  out.data_ptr(),
                  torch.cuda.current_stream(sym2.device).cuda_stream)
    return out


def window_identity_reference(sym2, qrow, trow, scal) -> torch.Tensor:
    """Plain tensor version of the window-identity kernel."""
    L = sym2.shape[1]
    q = sym2[qrow.to(torch.int64)].to(torch.int64)
    t = sym2[trow.to(torch.int64)].to(torch.int64)
    s = scal.to(torch.int64)
    qstart, tstart, win = s[:, 0:1], s[:, 1:2], s[:, 2:3]
    pos = torch.arange(L, device=sym2.device)[None, :]
    t = torch.gather(t, 1, (pos + (tstart - qstart) % L) % L)
    in_w = (pos >= qstart) & (pos < qstart + win)
    idc = ((q == t) & in_w).sum(dim=1)
    is_ct = lambda x: (x == ord("C")) | (x == ord("T"))  # noqa: E731
    ryc = ((is_ct(q) == is_ct(t)) & in_w).sum(dim=1)
    return torch.stack([idc, ryc], dim=1).to(torch.int32)


def window_identity_cuda(planes, n_seqs: int, qid, tid, is_rev, qstart,
                         tstart, win):
    """(idc, ryc) int64 arrays for all records."""
    return window_identity_collect(*window_identity_dispatch(
        planes, n_seqs, qid, tid, is_rev, qstart, tstart, win))


def window_identity_dispatch(planes, n_seqs: int, qid, tid, is_rev,
                             qstart, tstart, win):
    """Dispatch half of window_identity_cuda: returns the (host copy,
    n) pair with the device->host copy already streaming, so the caller
    can overlap other work before `window_identity_collect`."""
    sym2 = planes["sym"]
    dev = sym2.device
    n = len(qid)
    trow = np.asarray(tid, dtype=np.int64) + np.where(is_rev, n_seqs, 0)
    scal = np.zeros((n, 4), np.int32)
    scal[:, 0] = qstart
    scal[:, 1] = tstart
    scal[:, 2] = win
    out = window_identity(sym2, to_device(np.asarray(qid, np.int32), dev),
                          to_device(trow.astype(np.int32), dev),
                          to_device(scal, dev))
    return HostCopy(out), n


def window_identity_collect(out, n):
    res = out.numpy()
    return res[:n, 0].astype(np.int64), res[:n, 1].astype(np.int64)


_PURE = np.ones(256, dtype=bool)
_PURE[np.frombuffer(b"ACGT", dtype=np.uint8)] = False


def has_non_acgt_flags(seqdb) -> np.ndarray:
    """Per-sequence flag: contains any character outside uppercase ACGT
    (those records must take the host path for exact char semantics).
    Memoised on the SeqDB instance — stages treat SeqDB as immutable and
    several call this per iteration on the same DB."""
    cached = getattr(seqdb, "_non_acgt_flags", None)
    if cached is not None:
        return cached
    from .. import native
    flags = native.seq_non_acgt_flags(seqdb)
    try:
        seqdb._non_acgt_flags = flags
    except AttributeError:
        pass
    return flags
