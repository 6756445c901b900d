"""Candidate-overlap (prefilter) and alignment result tables.

The reference passes hits between stages as text records in mmap'd DBs:

  prefilter record:  "targetKey score diagonal"  (score<0 => reverse strand,
                     diagonal truncated through int16; QueryMatcher::
                     prefilterHitToBuffer, lib/mmseqs/src/prefiltering/
                     QueryMatcher.h:114-126)
  alignment record:  "targetKey bitScore seqId eval qStart qEnd qLen
                     dbStart dbEnd dbLen"  (Matcher::resultToBuffer,
                     lib/mmseqs/src/alignment/Matcher.cpp:356-405)

The TPU-native representation is flat NumPy arrays with a qkey column,
preserving per-query record order.  Text-format round-trip quirks (3-decimal
seqId truncation, %.3E e-values) are applied at table boundaries so numeric
state matches the reference bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def cpp_truncate_seqid(seq_id) -> np.ndarray:
    """Serialise-then-parse of seqId: float -> int(f*1000) -> "0.xyz" ->
    double -> float (Util::fastSeqIdToBuffer + strtod + float assignment)."""
    f = np.asarray(seq_id, dtype=np.float32)
    milli = (f * np.float32(1000.0)).astype(np.int32)  # C float->int truncation
    return (milli.astype(np.float64) / 1000.0).astype(np.float32)


def cpp_eval_roundtrip(eval_) -> np.ndarray:
    """Serialise-then-parse of the e-value through "%.3E".  E-values are
    computed from a few thousand distinct (score, qlen) pairs, so format
    only the unique values and scatter back."""
    e = np.atleast_1d(np.asarray(eval_, dtype=np.float64))
    uniq, inv = np.unique(e.ravel(), return_inverse=True)
    txt = np.char.mod("%.3E", uniq)
    return txt.astype(np.float64)[inv].reshape(e.shape)


@dataclass
class PrefDB:
    """Prefilter hits grouped per query, in record order."""
    qkey: np.ndarray        # uint32 per record
    tkey: np.ndarray        # uint32
    score: np.ndarray       # int32 (signed: negative == reverse strand)
    diag: np.ndarray        # int16-truncated diagonal, stored int32
    starts: np.ndarray      # int64 (nq+1,) record range per query
    qkeys: np.ndarray       # uint32 (nq,) distinct query keys in output order
    qext: np.ndarray | None = None  # wasExtended passthrough for empty entries

    def records_for(self, qi: int):
        s, e = self.starts[qi], self.starts[qi + 1]
        return slice(int(s), int(e))

    def save(self, prefix: str) -> None:
        np.savez(prefix + ".npz", qkey=self.qkey, tkey=self.tkey,
                 score=self.score, diag=self.diag, starts=self.starts,
                 qkeys=self.qkeys,
                 qext=self.qext if self.qext is not None else np.zeros(0, bool))

    @staticmethod
    def load(prefix: str) -> "PrefDB":
        z = np.load(prefix + ".npz")
        qext = z["qext"].astype(bool) if len(z["qext"]) else None
        return PrefDB(z["qkey"], z["tkey"], z["score"], z["diag"],
                      z["starts"], z["qkeys"], qext)

    def to_text(self) -> dict[int, str]:
        """Reference-format records for golden comparison."""
        out = {}
        for qi, qk in enumerate(self.qkeys):
            sl = self.records_for(qi)
            lines = [f"{int(t)}\t{int(s)}\t{int(d)}\n"
                     for t, s, d in zip(self.tkey[sl], self.score[sl], self.diag[sl])]
            out[int(qk)] = "".join(lines)
        return out


ALN_FIELDS = [
    ("tkey", np.uint32), ("score", np.int32), ("seq_id", np.float32),
    ("eval", np.float64), ("qstart", np.int32), ("qend", np.int32),
    ("qlen", np.int32), ("dbstart", np.int32), ("dbend", np.int32),
    ("dblen", np.int32),
]


@dataclass
class AlnDB:
    """Alignment results grouped per query, in record order (the 10-column
    record set of Matcher::result_t serialisation)."""
    qkey: np.ndarray
    cols: dict  # field -> np array, all length == len(qkey)
    starts: np.ndarray
    qkeys: np.ndarray

    def __len__(self):
        return len(self.qkey)

    def records_for(self, qi: int):
        s, e = self.starts[qi], self.starts[qi + 1]
        return slice(int(s), int(e))

    @property
    def aln_len(self) -> np.ndarray:
        """Matcher::computeAlnLength == max(qEnd-qStart, dbEnd-dbStart)+1
        (parseAlignmentRecord recomputes it on read)."""
        return np.maximum(self.cols["qend"] - self.cols["qstart"],
                          self.cols["dbend"] - self.cols["dbstart"]) + 1

    def slice_queries(self, lo: int, hi: int) -> "AlnDB":
        """Sub-AlnDB holding query GROUPS [lo, hi) with their records —
        the unit of work for distributed per-query stages (correction /
        extension are independent per query given the full SeqDB)."""
        s, e = int(self.starts[lo]), int(self.starts[hi])
        return AlnDB(self.qkey[s:e],
                     {k: v[s:e] for k, v in self.cols.items()},
                     self.starts[lo:hi + 1] - s,
                     self.qkeys[lo:hi])

    def save(self, prefix: str) -> None:
        np.savez(prefix + ".npz", qkey=self.qkey, starts=self.starts,
                 qkeys=self.qkeys, **self.cols)

    @staticmethod
    def load(prefix: str) -> "AlnDB":
        z = np.load(prefix + ".npz")
        cols = {name: z[name] for name, _ in ALN_FIELDS}
        return AlnDB(z["qkey"], cols, z["starts"], z["qkeys"])

    def to_text(self) -> dict[int, str]:
        out = {}
        c = self.cols
        for qi, qk in enumerate(self.qkeys):
            sl = self.records_for(qi)
            lines = []
            for i in range(sl.start, sl.stop):
                sid = c["seq_id"][i]
                # "1.00" not "1.000": fastSeqIdToBuffer returns a pointer AT
                # its '\0' (not past it), so resultToBuffer's tab overwrite
                # eats the final '0' for the 1.0 case (Util.cpp:fastSeqIdTo-
                # Buffer + Matcher.cpp:358-360)
                sid_txt = "1.00" if sid == 1.0 else \
                    "0." + ("%03d" % int(np.float32(sid) * np.float32(1000.0)))
                lines.append("%d\t%d\t%s\t%.3E\t%d\t%d\t%d\t%d\t%d\t%d\n" % (
                    c["tkey"][i], c["score"][i], sid_txt, c["eval"][i],
                    c["qstart"][i], c["qend"][i], c["qlen"][i],
                    c["dbstart"][i], c["dbend"][i], c["dblen"][i]))
            out[int(qk)] = "".join(lines)
        return out

    @staticmethod
    def from_arrays(qkey, qkeys, starts, **cols) -> "AlnDB":
        cast = {name: np.asarray(cols[name], dtype=dt) for name, dt in ALN_FIELDS}
        return AlnDB(np.asarray(qkey, dtype=np.uint32), cast,
                     np.asarray(starts, dtype=np.int64),
                     np.asarray(qkeys, dtype=np.uint32))
