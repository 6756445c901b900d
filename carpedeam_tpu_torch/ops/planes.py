"""Sequence planes on the device: the stacked (2N, L) symbol and code
planes that every kernel of an iteration reads.

Torch twin of carpedeam_tpu/ops/rescore_tpu.py:37-191:

  code      5-letter scoring codes (A0 C1 T2 G3 X4)
  sym       case-folded symbol bytes (for char-equality seqId)

stacked [fwd; rc] so strand selection is row arithmetic (row = idx +
N * is_rev); the rc rows are row-reversed reverse complements, so the
strand-corrected position x reads directly at [i, x].  Only the forward
symbol plane crosses the host->device link (pinned memory, side stream);
the rc rows, the code planes and the device lengths derive on the
device as plain tensor ops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import CHAR_TO_CODE

# byte -> 5-letter code for uppercased symbols (A0 C1 T2 G3, else X4),
# and byte -> complement symbol ("ACTGX" folding), as 256-entry tables
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
_COMP_LUT = np.full(256, ord("X"), dtype=np.uint8)
for _chars, _val, _comp in (("A", 0, "T"), ("CMYH", 1, "G"),
                            ("TUW", 2, "A"), ("GKBDVRS", 3, "C")):
    for _ch in _chars:
        _CODE_LUT[ord(_ch)] = _val
        _COMP_LUT[ord(_ch)] = ord(_comp)


def pack_sequences(seqdb, max_len=None, ids=None, fwd_only=False):
    """Host-side: SeqDB -> dict of stacked device planes + lengths.

    Returns (planes, lengths) where planes = {"code": (2N, L) uint8,
    "sym": (2N, L) uint8}; rows [0, N) are forward, rows [N, 2N) are the
    row-reversed reverse complements.  `ids` restricts packing to a row
    subset (for per-length-bucket planes); rows longer than max_len are
    truncated (callers must route such rows to a wider bucket).

    `fwd_only=True` returns just {"sym": (N, L)} — the forward symbol
    plane — for callers that derive the RC rows and code planes on
    the device (device_planes)."""
    if ids is None:
        n = len(seqdb)
        lengths = seqdb.lengths.astype(np.int64)
        offsets = seqdb.offsets.astype(np.int64)
    else:
        n = len(ids)
        lengths = seqdb.lengths[ids].astype(np.int64)
        offsets = seqdb.offsets[ids].astype(np.int64)
    if max_len is None:
        max_len = int(lengths.max()) if n else 1
    if n:
        # one-pass C++ pack (native/linclust_kernels.cpp::pack_planes)
        from .. import native
        sym, sym_rc, code, code_rc = native.pack_planes(
            seqdb.data, seqdb.offsets.astype(np.int64),
            seqdb.lengths.astype(np.int64),
            np.asarray(ids, dtype=np.int64) if ids is not None else None,
            max_len)
    else:
        sym = sym_rc = np.zeros((0, max_len), dtype=np.uint8)
        code = code_rc = CHAR_TO_CODE[sym]
    if fwd_only:
        return {"sym": sym}, lengths.astype(np.int32)
    planes = {"code": np.concatenate([code, code_rc]),
              "sym": np.concatenate([sym, sym_rc])}
    return planes, lengths.astype(np.int32)


# plane cells (rows x width) one derivation pass covers: a pass's
# temporaries stay this many cells (its int64 gather index, 512 MiB, the
# largest) however many rows the plane has; an int64 copy of a whole
# 10M-row, 512-wide plane would take 41 GB
DERIVE_CELLS = 1 << 26


def _lut(table: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(table).to(device)


def row_chunks(n: int, width: int):
    """(start, stop) row ranges of an (n, width) plane, at most
    DERIVE_CELLS cells and at least one row each."""
    step = max(1, DERIVE_CELLS // max(width, 1))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def lookup(lut: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """lut[x] for a uint8 tensor x, through an int32 index."""
    return lut.index_select(0, x.reshape(-1).to(torch.int32)) \
        .reshape(x.shape)


def derive_code(sym2: torch.Tensor) -> torch.Tensor:
    """Uppercased symbols -> 5-letter codes (X=4 for padding and
    non-ACGT), as the JAX package's _derive_code where-chain; in row
    chunks."""
    lut = _lut(_CODE_LUT, sym2.device)
    out = torch.empty_like(sym2)
    for a, b in row_chunks(sym2.shape[0], sym2.shape[1]):
        out[a:b] = lookup(lut, sym2[a:b])
    return out


def derive_rc_plane(sym: torch.Tensor, lengths: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """Reverse-complement symbol rows from the forward plane, written into
    `out`: complement, flip, rotate row i left by L - len_i, mask past
    len_i, as the JAX package's _derive_rc_plane; its barrel shifter
    takes the rotation's low bit_length(L - 1) bits, which a row
    truncated to the plane (len_i > L) at a width that is no power of two
    shows.  In row chunks."""
    n, max_len = sym.shape
    lut = _lut(_COMP_LUT, sym.device)
    pos = torch.arange(max_len, device=sym.device, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.uint8, device=sym.device)
    mask = (1 << max(1, (max_len - 1).bit_length())) - 1
    for a, b in row_chunks(n, max_len):
        lens = lengths[a:b].to(torch.int32)[:, None]
        # flipped column (x + shift) mod L is forward column L-1 minus it;
        # int32 arithmetic, widened once for gather's int64 index
        shift = (max_len - lens) & mask
        src = (max_len - 1 - (pos[None, :] + shift) % max_len).long()
        rolled = lookup(lut, torch.gather(sym[a:b], 1, src))
        out[a:b] = torch.where(pos[None, :] < lens, rolled, zero)
    return out


def assemble_planes(sym_fwd: torch.Tensor, lengths: torch.Tensor) -> dict:
    """(N, L) forward symbols + lengths -> {"code", "sym": (2N, L) uint8,
    "len": (N,) int32} on the same device, derived in row chunks."""
    n, width = sym_fwd.shape
    sym2 = torch.empty((2 * n, width), dtype=torch.uint8,
                       device=sym_fwd.device)
    sym2[:n] = sym_fwd
    derive_rc_plane(sym_fwd, lengths, sym2[n:])
    return {"code": derive_code(sym2), "sym": sym2,
            "len": lengths.to(torch.int32)}


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on `device` (synchronous copy)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class PlanesPrefetch:
    """Asynchronous device_planes: the host pack and the host->device copy
    start at construction (pinned memory, side stream); the caller does
    host work (the kmermatcher) meanwhile, and `get()` makes the current
    stream wait on the copy's event and derives the planes."""

    def __init__(self, seqdb, max_len=None, ids=None, device="cuda"):
        from ..utils import subtimer
        self.device = torch.device(device)
        with subtimer("planes.pack_host"):
            planes, self.lengths = pack_sequences(
                seqdb, max_len=max_len, ids=ids, fwd_only=True)
        host = torch.from_numpy(planes["sym"])
        self._event = None
        with subtimer("planes.h2d_dispatch"):
            if self.device.type == "cuda":
                stream = torch.cuda.Stream(device=self.device)
                host = host.pin_memory()
                with torch.cuda.stream(stream):
                    self._sym_fwd = host.to(self.device, non_blocking=True)
                    self._len = torch.from_numpy(self.lengths).pin_memory() \
                        .to(self.device, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(stream)
                # the pinned buffers must outlive the copy
                self._pinned = host
                self._stream = stream
            else:
                self._sym_fwd = host
                self._len = torch.from_numpy(self.lengths)
        self._out = None

    def get(self):
        from ..utils import subtimer
        if self._out is None:
            with subtimer("planes.h2d_wait"):
                if self._event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(self._event)
                    self._sym_fwd.record_stream(cur)
                    self._len.record_stream(cur)
            with subtimer("planes.derive_dev"):
                self._out = assemble_planes(self._sym_fwd, self._len)
        return self._out, self.lengths


def device_planes(seqdb, max_len=None, ids=None, device="cuda"):
    """pack_sequences + upload of the forward symbol plane; the rc rows,
    the code planes and the device lengths derive on the device.  Returns
    ({"code", "sym", "len"} tensors, host lengths)."""
    return PlanesPrefetch(seqdb, max_len=max_len, ids=ids,
                          device=device).get()


class HostCopy:
    """Device->host copy started now (pinned buffer, event) and collected
    by `numpy()`; on the CPU it is the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
