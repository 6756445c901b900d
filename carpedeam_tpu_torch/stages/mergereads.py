"""mergereads: FLASH paired-end overlap merging.

Port of carpedeam_tpu/stages/mergereads.py (host NumPy, no device work):
the same functions, the same semantics.  Re-design of
src/assembler/mergereads.cpp + lib/flash/combine_reads.cpp: read 2 is
reverse-complemented, then every candidate overlap position is scored by
mismatch density (N positions excluded) with quality-sum tie breaks; the
best overlap below density 0.10 merges the pair (overlap bases resolved
by quality).  Parameters fixed by the reference: max_overlap 65,
min_overlap 15, max_mismatch_density 0.10, no outies
(mergereads.cpp:19-24).
"""
from __future__ import annotations

import gzip

import numpy as np

from ..io.seqdb import SeqDB

MIN_OVERLAP = 15
MAX_OVERLAP = 65
MAX_MISMATCH_DENSITY = 0.10

_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[_a] = _b


def revcomp_read(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq][::-1]


def combine_pair(seq1: np.ndarray, qual1: np.ndarray,
                 seq2rc: np.ndarray, qual2r: np.ndarray):
    """FLASH combine_reads for one pair (read 2 already reverse-complemented,
    its qualities reversed).  Returns merged sequence bytes or None."""
    l1, l2 = len(seq1), len(seq2rc)
    best_density = MAX_MISMATCH_DENSITY + 1.0
    best_qual = 0.0
    best_pos = None
    start = max(0, l1 - l2)
    for i in range(start, l1 - MIN_OVERLAP + 1):
        n = min(l1 - i, l2)
        s1 = seq1[i:i + n]
        s2 = seq2rc[:n]
        not_n = (s1 != ord("N")) & (s2 != ord("N"))
        eff_len = int(not_n.sum())
        if eff_len < MIN_OVERLAP:
            continue
        mm = (s1 != s2) & not_n
        num_mm = int(mm.sum())
        qual_total = int(np.minimum(qual1[i:i + n], qual2r[:n])[mm].sum())
        score_len = np.float32(min(eff_len, MAX_OVERLAP))
        density = np.float32(num_mm) / score_len
        qscore = np.float32(qual_total) / score_len
        if density <= best_density and (density < best_density
                                        or qscore < best_qual):
            best_density = float(density)
            best_qual = float(qscore)
            best_pos = i
    if best_pos is None or best_density > MAX_MISMATCH_DENSITY:
        return None
    return splice_pair(seq1, qual1, seq2rc, qual2r, best_pos)


def splice_pair(seq1, qual1, seq2rc, qual2r, i):
    """Combine a pair at overlap position i (quality-resolved bases)."""
    l1, l2 = len(seq1), len(seq2rc)
    n = min(l1 - i, l2)
    head = seq1[:i]
    tail = seq2rc[n:]
    s1, s2 = seq1[i:i + n], seq2rc[:n]
    q1, q2 = qual1[i:i + n], qual2r[:n]
    same = s1 == s2
    pick1 = q1 > q2
    pick2 = q1 < q2
    # equal quality: take read 2's base unless it is N
    eq_pick1 = (~pick1) & (~pick2) & (s2 == ord("N"))
    mid = np.where(same | pick1 | eq_pick1, s1, s2)
    return np.concatenate([head, mid, tail]).tobytes()


def combine_pairs_batch(p1, q1, l1, p2, q2, l2):
    """Vectorised FLASH overlap scan over padded pair planes.

    p1/q1: (P, Lmax) uint8 sequence/quality planes for read 1;
    p2/q2: same for read 2 (already reverse-complemented / reversed);
    l1/l2: true lengths.  Returns (best_pos int64 with -1 for unmerged).

    The position loop keeps the oracle's exact sequential update rule
    (`density <= best && (density < best || qscore < best_qual)`,
    lib/flash/combine_reads.cpp) — vectorised across pairs per position.
    """
    P, Lmax = p1.shape
    best_density = np.full(P, MAX_MISMATCH_DENSITY + 1.0, dtype=np.float64)
    best_qual = np.zeros(P, dtype=np.float64)
    best_pos = np.full(P, -1, dtype=np.int64)
    start = np.maximum(0, l1 - l2)
    pos = np.arange(Lmax, dtype=np.int64)[None, :]
    not_n2 = p2 != ord("N")
    for i in range(0, int(l1.max()) - MIN_OVERLAP + 1):
        active = (i >= start) & (i <= l1 - MIN_OVERLAP)
        if not active.any():
            continue
        n = np.minimum(l1 - i, l2)
        in_win = pos < n[:, None]
        s1 = p1[:, i:]
        w = s1.shape[1]
        nn = (s1 != ord("N")) & not_n2[:, :w] & in_win[:, :w]
        eff_len = nn.sum(axis=1)
        mm = (s1 != p2[:, :w]) & nn
        num_mm = mm.sum(axis=1)
        qual_total = np.where(mm, np.minimum(q1[:, i:], q2[:, :w]),
                              0).sum(axis=1)
        score_len = np.minimum(eff_len, MAX_OVERLAP).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            density = (num_mm.astype(np.float32) / score_len) \
                .astype(np.float64)
            qscore = (qual_total.astype(np.float32) / score_len) \
                .astype(np.float64)
        ok = active & (eff_len >= MIN_OVERLAP)
        upd = ok & (density <= best_density) \
            & ((density < best_density) | (qscore < best_qual))
        best_density[upd] = density[upd]
        best_qual[upd] = qscore[upd]
        best_pos[upd] = i
    best_pos[best_density > MAX_MISMATCH_DENSITY] = -1
    return best_pos


def _read_fastq(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            s = fh.readline().rstrip("\n")
            fh.readline()
            q = fh.readline().rstrip("\n")
            yield h.rstrip("\n")[1:], s, q


def mergereads(paths: list[str]) -> SeqDB:
    """Merge paired FASTQ files (R1a R2a R1b R2b ...) into a SeqDB.

    Merged pairs produce one record (ext flag False); unmerged pairs keep
    both reads as separate records, preserving the reference's sequential
    key assignment (mergereads.cpp:80-116)."""
    if len(paths) % 2 != 0:
        raise ValueError("paired-end input requires an even number of files")
    seqs, headers = [], []
    CHUNK = 65536        # pairs per batched scan (bounds plane memory)
    for fi in range(0, len(paths), 2):
        it1 = _read_fastq(paths[fi])
        it2 = _read_fastq(paths[fi + 1])
        batch: list = []
        for rec in zip(it1, it2):
            batch.append(rec)
            if len(batch) >= CHUNK:
                _merge_batch(batch, seqs, headers)
                batch = []
        if batch:
            _merge_batch(batch, seqs, headers)
    return SeqDB.from_sequences(seqs, headers=headers)


def _merge_batch(batch, seqs, headers):
    """Batched FLASH scan over one chunk of pairs (vectorised positions),
    then per-pair splicing of the winners."""
    P = len(batch)
    a1s, qa1s, a2s, qa2s = [], [], [], []
    for (h1, s1, q1), (h2, s2, q2) in batch:
        if not s1 or not s2 or not q1 or not q2:
            raise ValueError("Invalid sequence/quality record")
        a1s.append(np.frombuffer(s1.encode(), dtype=np.uint8))
        qa1s.append(np.frombuffer(q1.encode(), dtype=np.uint8))
        a2s.append(revcomp_read(np.frombuffer(s2.encode(), dtype=np.uint8)))
        qa2s.append(np.frombuffer(q2.encode(), dtype=np.uint8)[::-1])
    l1 = np.array([len(a) for a in a1s], dtype=np.int64)
    l2 = np.array([len(a) for a in a2s], dtype=np.int64)
    Lmax = int(max(l1.max(), l2.max()))
    p1 = np.zeros((P, Lmax), dtype=np.uint8)
    p2 = np.zeros((P, Lmax), dtype=np.uint8)
    q1p = np.zeros((P, Lmax), dtype=np.uint8)
    q2p = np.zeros((P, Lmax), dtype=np.uint8)
    for j in range(P):
        p1[j, :l1[j]] = a1s[j]
        q1p[j, :l1[j]] = qa1s[j]
        p2[j, :l2[j]] = a2s[j]
        q2p[j, :l2[j]] = qa2s[j]
    best_pos = combine_pairs_batch(p1, q1p, l1, p2, q2p, l2)
    for j in range(P):
        (h1, s1, _), (h2, _, _) = batch[j]
        name1 = h1.split()[0] if h1 else h1
        if best_pos[j] >= 0:
            seqs.append(splice_pair(a1s[j], qa1s[j], a2s[j], qa2s[j],
                                    int(best_pos[j])))
            headers.append(name1)
        else:
            seqs.append(s1.encode())
            headers.append(name1)
            seqs.append(a2s[j].tobytes())
            headers.append(h2.split()[0] if h2 else h2)
