"""cyclecheck: circular / terminally-redundant contig detection.

Re-design of src/assembler/cyclecheck.cpp: split each contig into thirds,
count shared 22-mers between thirds per diagonal (diag >= L/3 only), and
call the contig circular when some diagonal band (±1% gap window) reaches
a hit rate > 0.24; optionally chop the sequence at the split diagonal.

The per-contig test runs in one native batch call
(native/host_kernels.cpp::cyclecheck_batch).
"""
from __future__ import annotations

import numpy as np

from ..io.seqdb import SeqDB


def cyclecheck(seqdb: SeqDB, k: int = 22, chop: bool = True,
               max_seq_len: int = 200000):
    """Returns (cycle SeqDB, none_cycle SeqDB): circular contigs (chopped)
    and the remainder, mirroring the script's cycle/noneCycle split
    (data/nuclassemble.sh:19-61)."""
    from .. import native

    split = native.cyclecheck_batch(seqdb.data, seqdb.offsets,
                                    seqdb.lengths, k, max_seq_len)
    cyc_seqs, cyc_keys, cyc_ext = [], [], []
    keep_idx = []
    for i in range(len(seqdb)):
        if split[i] > 0:
            sb = seqdb.seq_bytes(i)
            cyc_seqs.append(bytes(sb[:split[i]]) if chop else bytes(sb))
            cyc_keys.append(int(seqdb.keys[i]))
            cyc_ext.append(bool(seqdb.ext[i]))
        else:
            keep_idx.append(i)
    cyc = SeqDB.from_sequences(cyc_seqs,
                               keys=np.array(cyc_keys, dtype=np.uint32),
                               ext=np.array(cyc_ext, dtype=bool))
    none_cyc = seqdb.select(np.array(keep_idx, dtype=np.int64)) \
        if keep_idx else SeqDB.from_sequences([])
    return cyc, none_cyc
