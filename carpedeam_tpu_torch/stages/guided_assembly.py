"""guidedassembleresult: PenguiN's protein-guided nucleotide extension.

Port of src/assembler/guidedassembleresult.cpp — the Plass/PenguiN
six-frame-guided extension step.  The reference compiles this module and
declares it (src/LocalCommandDeclarations.h:9) but does not register it
in the CarpeDeam command table, and the workflow block that would call it
is commented out (data/guidedNuclAssemble.sh:42-139); it is provided here
for capability parity with the compiled binary.  The port's copy of
carpedeam_tpu/stages/guided_assembly.py: host NumPy, no device work, in
both packages.

Per query: nucleotide alignments are ranked by a Beta-distribution
posterior over mismatch counts (CompareResultBySeqId,
guidedassembleresult.cpp:39-74), and the query is greedily extended
left/right by the best terminal overlaps, guarded by stop codons in the
companion amino-acid sequences ('*' at the relevant end blocks extension
over a codon boundary, :235-247); deferred candidates are re-aligned by
diagonal against the grown query and re-queued while above the seqId
threshold.  Outputs the extended nucleotide and amino-acid DBs with the
extended flag set for assembled queries (wasExtended 0x20).
"""
from __future__ import annotations

import math

import numpy as np

from ..aligndb import AlnDB
from ..io.seqdb import SeqDB
from ..ops.likelihood import CppPriorityQueue
from .read_assembly import _ungapped_realign


class _Cand:
    __slots__ = ("tkey", "qstart", "qend", "qlen", "tstart", "tend", "tlen",
                 "aln_len", "seq_id")

    def __init__(self, tkey, qstart, qend, qlen, tstart, tend, tlen,
                 aln_len, seq_id):
        self.tkey = tkey
        self.qstart, self.qend, self.qlen = qstart, qend, qlen
        self.tstart, self.tend, self.tlen = tstart, tend, tlen
        self.aln_len = aln_len
        self.seq_id = seq_id


def _beta_less(r1: _Cand, r2: _Cand) -> bool:
    """CompareResultBySeqId (guidedassembleresult.cpp:39-74): P(p1 > p2)
    over Beta posteriors of the mismatch fractions; ties -> smaller
    unaligned overhang wins the comparison."""
    mm1 = int((1 - np.float32(r1.seq_id)) * np.float32(r1.aln_len)
              + np.float32(0.5))
    mm2 = int((1 - np.float32(r2.seq_id)) * np.float32(r2.aln_len)
              + np.float32(0.5))
    alpha1, alpha2 = mm1 + 1, mm2 + 1
    beta1 = r1.aln_len - mm1 + 1
    beta2 = r2.aln_len - mm2 + 1
    log_c = (math.lgamma(beta1 + beta2) + math.lgamma(alpha1 + beta1)) \
        - (math.lgamma(alpha1 + beta1 + beta2) + math.lgamma(beta1))
    log_r = 0.0
    p = 0.0
    for idx in range(alpha2):
        p += math.exp(log_r + log_c)
        log_r = (math.log(alpha1 + idx) + math.log(beta2 + idx)
                 - (math.log(idx + 1)
                    + math.log(idx + alpha1 + beta1 + beta2)) + log_r)
    if p < 0.45:
        return True
    if p > 0.55:
        return False
    if r1.tlen - r1.aln_len < r2.tlen - r2.aln_len:
        return True
    if r1.tlen - r1.aln_len > r2.tlen - r2.aln_len:
        return False
    return True


def guided_assembly(nucl: SeqDB, aa: SeqDB, aln: AlnDB, seq_id_thr: float,
                    max_seq_len: int = 300000):
    """Returns (extended nucl SeqDB, extended aa SeqDB)."""
    key2id = nucl.key_to_id()
    aa_key2id = aa.key_to_id()
    aln_by_key = {int(k): i for i, k in enumerate(aln.qkeys)}
    aln_len_all = aln.aln_len

    out_n, out_a, out_ext = [], [], []
    for i in range(len(nucl)):
        qkey = int(nucl.keys[i])
        nq = bytearray(nucl.seq_bytes(i).tobytes())
        aq = bytearray(aa.seq_bytes(aa_key2id[qkey]).tobytes())
        exclude_left = aq[:1] == b"*"
        exclude_right = aq[-1:] == b"*"

        qi = aln_by_key.get(qkey)
        sl = aln.records_for(qi) if qi is not None else slice(0, 0)
        queue = CppPriorityQueue(_beta_less)
        n_rec = sl.stop - sl.start
        for r in range(sl.start, sl.stop):
            if aln.cols["seq_id"][r] < np.float32(seq_id_thr):
                continue
            queue.push(_Cand(
                int(aln.cols["tkey"][r]), int(aln.cols["qstart"][r]),
                int(aln.cols["qend"][r]), int(aln.cols["qlen"][r]),
                int(aln.cols["dbstart"][r]), int(aln.cols["dbend"][r]),
                int(aln.cols["dblen"][r]), int(aln_len_all[r]),
                float(aln.cols["seq_id"][r])))

        could_extend = False
        while not queue.empty():
            left_off = 0
            right_off = 0
            deferred: list[_Cand] = []
            broke = False
            while not queue.empty():
                # selectBestFragmentToExtend
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
                tid = key2id[best.tkey]
                tnucl = nucl.seq_bytes(tid)
                tlen = int(nucl.lengths[tid])
                taa = aa.seq_bytes(aa_key2id[best.tkey])
                # stop-codon guards (:235-247)
                if best.tstart == 0:
                    if (tlen - (best.tend + 1)) <= right_off \
                            or exclude_right or taa[:1].tobytes() == b"*":
                        continue
                elif best.qstart == 0:
                    if best.tstart <= left_off or exclude_left \
                            or taa[-1:].tobytes() == b"*":
                        continue
                if best.tstart == 0 and best.qend == len(nq) - 1:
                    if right_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = (tlen - best.tend) - 1
                    if len(nq) + frag_len >= max_seq_len:
                        broke = True
                        break
                    aa_frag_len = (tlen // 3 - best.tend // 3) - 1
                    nq += tnucl[best.tend + 1:].tobytes()
                    aa_start = best.tend // 3 + 1
                    aq += taa[aa_start:aa_start + aa_frag_len].tobytes()
                    right_off += frag_len
                elif best.qstart == 0 and best.tend == tlen - 1:
                    if left_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = best.tstart
                    if len(nq) + frag_len >= max_seq_len:
                        broke = True
                        break
                    has_start = 1 if taa[:1].tobytes() == b"*" else 0
                    nq[:0] = tnucl[:frag_len].tobytes()
                    aq[:0] = taa[:frag_len // 3 + has_start].tobytes()
                    left_off += frag_len

            if left_off > 0 or right_off > 0:
                could_extend = True
            if broke and not queue.empty():
                break

            qarr = np.frombuffer(bytes(nq), dtype=np.uint8)
            for c in deferred:
                diag = (c.qstart + left_off) - c.tstart
                tid = key2id[c.tkey]
                tb = nucl.seq_bytes(tid)
                score, start, end, dlen, dist = _ungapped_realign(qarr, tb,
                                                                  diag)
                if diag >= 0:
                    c.qstart, c.qend = start + dist, end + dist
                    c.tstart, c.tend = start, end
                else:
                    c.qstart, c.qend = start, end
                    c.tstart, c.tend = start + dist, end + dist
                id_cnt = 0
                if c.qend > c.qstart:
                    qw = qarr[c.qstart:c.qend]
                    tw = tb[c.tstart:c.tstart + (c.qend - c.qstart)]
                    id_cnt = int((qw == tw).sum())
                denom = np.float32(c.qend) - np.float32(c.qstart)
                c.seq_id = float(np.float32(id_cnt) / denom) if denom else 0.0
                c.qlen = len(qarr)
                c.aln_len = dlen
                if c.seq_id >= np.float32(seq_id_thr):
                    queue.push(c)

        out_n.append(bytes(nq))
        out_a.append(bytes(aq))
        out_ext.append(could_extend)

    ext = np.array(out_ext, dtype=bool)
    return (SeqDB.from_sequences(out_n, keys=nucl.keys.copy(), ext=ext),
            SeqDB.from_sequences(out_a, keys=nucl.keys.copy(), ext=ext))
