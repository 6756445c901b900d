"""Sequence database: packed array store with MMseqs2-DB interop.

The reference moves all state between pipeline stages through mmap'd
"MMseqs2 DBs" (flat records + `key offset length [wasExtended]` index;
lib/mmseqs/src/commons/DBReader.cpp:808-817, DBWriter.cpp:415-424).  The
TPU-native equivalent is a CSR-style array store:

    data     uint8   flat concatenated sequence bytes (raw ASCII)
    offsets  int64   start of each record in `data`
    lengths  int64   sequence length (no terminators)
    keys     uint32  stable record keys (survive filtering)
    ext      bool    the CarpeDeam `wasExtended` / "is contig" flag

Stages are pure SeqDB -> SeqDB functions; `save`/`load` give the same
stage-granular checkpoint contract as the reference's on-disk DBs, and
`read_mmseqs`/`write_mmseqs` allow golden-testing against the reference
binary's intermediate files.
"""
from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SeqDB:
    data: np.ndarray                 # uint8 flat
    offsets: np.ndarray              # int64 (n,)
    lengths: np.ndarray              # int64 (n,)
    keys: np.ndarray                 # uint32 (n,)
    ext: np.ndarray                  # bool (n,)
    headers: list | None = None      # optional per-record header strings
    dbtype: int = 1                  # 1 = nucleotides (Parameters::DBTYPE_NUCLEOTIDES)

    # ------------------------------------------------------------------ basic
    def __len__(self) -> int:
        return len(self.offsets)

    def seq_bytes(self, i: int) -> np.ndarray:
        o = self.offsets[i]
        return self.data[o:o + self.lengths[i]]

    def seq_str(self, i: int) -> str:
        return self.seq_bytes(i).tobytes().decode("ascii")

    def key_to_id(self) -> dict:
        return {int(k): i for i, k in enumerate(self.keys)}

    def key_id_map(self) -> np.ndarray:
        """Vectorised key->row lookup table (keys are small ints); use
        `m[keys]` instead of a per-record dict lookup loop.  Lookups of
        keys absent from the DB must be validated by the caller (or use
        `lookup_keys`, which raises)."""
        m = np.full(int(self.keys.max()) + 1 if len(self.keys) else 1, -1,
                    dtype=np.int64)
        m[self.keys.astype(np.int64)] = np.arange(len(self.keys))
        return m

    def lookup_keys(self, keys: np.ndarray) -> np.ndarray:
        """Vectorised key->row lookup that raises KeyError on any stale
        key (a -1 from key_id_map would otherwise silently index the last
        row)."""
        keys = np.asarray(keys, dtype=np.int64)
        m = self.key_id_map()
        if len(keys) and (keys.max() >= len(m) or keys.min() < 0):
            bad = keys[(keys >= len(m)) | (keys < 0)]
            raise KeyError(f"keys not in SeqDB: {bad[:5].tolist()}...")
        rows = m[keys]
        if (rows < 0).any():
            bad = keys[rows < 0]
            raise KeyError(f"keys not in SeqDB: {bad[:5].tolist()}...")
        return rows

    @property
    def total_residues(self) -> int:
        """Sum of sequence lengths == DBReader::getAminoAcidDBSize for a
        nucleotide DB (used as the e-value database size)."""
        return int(self.lengths.sum())

    # ------------------------------------------------------------- construction
    @staticmethod
    def from_sequences(seqs, keys=None, ext=None, headers=None) -> "SeqDB":
        bs = [s.encode("ascii") if isinstance(s, str) else bytes(s) for s in seqs]
        lengths = np.array([len(b) for b in bs], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64) \
            if len(bs) else np.zeros(0, dtype=np.int64)
        data = np.frombuffer(b"".join(bs), dtype=np.uint8).copy() \
            if len(bs) else np.zeros(0, dtype=np.uint8)
        n = len(bs)
        keys = np.arange(n, dtype=np.uint32) if keys is None else np.asarray(keys, dtype=np.uint32)
        ext = np.zeros(n, dtype=bool) if ext is None else np.asarray(ext, dtype=bool)
        return SeqDB(data, offsets, lengths, keys, ext, headers)

    @staticmethod
    def from_flat(data: np.ndarray, lengths: np.ndarray, keys=None,
                  ext=None, headers=None) -> "SeqDB":
        """Construct directly from a dense flat byte array (records
        concatenated with no separators) without re-joining sequences."""
        lengths = np.asarray(lengths, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]) \
            .astype(np.int64) if len(lengths) else np.zeros(0, np.int64)
        n = len(lengths)
        keys = np.arange(n, dtype=np.uint32) if keys is None \
            else np.asarray(keys, dtype=np.uint32)
        ext = np.zeros(n, dtype=bool) if ext is None \
            else np.asarray(ext, dtype=bool)
        return SeqDB(np.asarray(data, dtype=np.uint8), offsets, lengths,
                     keys, ext, headers)

    def select(self, idx) -> "SeqDB":
        """Sub-DB of rows `idx` (createsubdb equivalent)."""
        idx = np.asarray(idx)
        seqs = [self.seq_bytes(int(i)) for i in idx]
        headers = [self.headers[int(i)] for i in idx] if self.headers else None
        return SeqDB.from_sequences(
            [bytes(s) for s in seqs], keys=self.keys[idx], ext=self.ext[idx],
            headers=headers)

    # ------------------------------------------------------------ fasta/fastq
    @staticmethod
    def from_fastx(path: str, shuffle: bool = True) -> "SeqDB":
        """FASTA/FASTQ(.gz) ingest (createdb equivalent,
        lib/mmseqs/src/util/createdb.cpp).

        `shuffle=True` replicates createdb's default --shuffle: records are
        distributed round-robin over 32 split writers by input index
        (splitIdx = id % 32; createdb.cpp:60,221) and the splits are
        concatenated, with keys renumbered 0..N-1 in merged order.  The
        resulting permutation is what gives the reference its record
        numbering, which downstream tie-breaks depend on."""
        opener = gzip.open if path.endswith(".gz") else open
        seqs, headers = [], []
        with opener(path, "rt") as fh:
            first = fh.read(1)
            fh.seek(0)
            if first == ">":
                cur = []
                for line in fh:
                    line = line.rstrip("\n")
                    if line.startswith(">"):
                        if cur:
                            seqs.append("".join(cur))
                            cur = []
                        headers.append(line[1:])
                    else:
                        cur.append(line)
                if cur:
                    seqs.append("".join(cur))
            elif first == "@":
                while True:
                    h = fh.readline()
                    if not h:
                        break
                    s = fh.readline().rstrip("\n")
                    fh.readline()  # +
                    fh.readline()  # qual
                    headers.append(h.rstrip("\n")[1:])
                    seqs.append(s)
            else:
                raise ValueError(f"{path}: not FASTA/FASTQ")
        if shuffle and seqs:
            n = len(seqs)
            perm = np.concatenate([np.arange(s, n, 32) for s in range(32)])
            seqs = [seqs[int(i)] for i in perm]
            headers = [headers[int(i)] for i in perm]
        return SeqDB.from_sequences(seqs, headers=headers)

    def to_fasta(self, path: str, headers=None) -> None:
        """convert2fasta equivalent."""
        hs = headers or self.headers
        with open(path, "w") as fh:
            for i in range(len(self)):
                h = hs[i] if hs else str(int(self.keys[i]))
                fh.write(f">{h}\n{self.seq_str(i)}\n")

    # ------------------------------------------------------------- checkpoints
    def save(self, prefix: str, compressed: bool = False) -> None:
        """Checkpoint to <prefix>.npz; `compressed` (the --compressed /
        DBWriter zstd role) stores deflated members — load() reads both
        transparently."""
        writer = np.savez_compressed if compressed else np.savez
        writer(prefix + ".npz", data=self.data, offsets=self.offsets,
               lengths=self.lengths, keys=self.keys, ext=self.ext,
               dbtype=np.int64(self.dbtype))
        if self.headers is not None:
            with open(prefix + ".headers", "w") as fh:
                for h in self.headers:
                    fh.write(h + "\n")

    @staticmethod
    def load(prefix: str) -> "SeqDB":
        z = np.load(prefix + ".npz")
        headers = None
        if os.path.exists(prefix + ".headers"):
            with open(prefix + ".headers") as fh:
                headers = [l.rstrip("\n") for l in fh]
        return SeqDB(z["data"], z["offsets"], z["lengths"], z["keys"],
                     z["ext"].astype(bool), headers, int(z["dbtype"]))

    # -------------------------------------------------------- mmseqs interop
    @staticmethod
    def _read_dbtype(db_path: str) -> int:
        """Raw .dbtype word (low 16 bits: type; bit 31: zstd-compressed
        entries — DBReader.cpp:1018)."""
        try:
            with open(db_path + ".dbtype", "rb") as fh:
                return int(np.frombuffer(fh.read(4), dtype=np.int32)[0])
        except (OSError, IndexError):
            return 0

    @staticmethod
    def _decompress_entry(raw: np.ndarray, off: int) -> bytes:
        """One compressed DB entry at byte offset `off`: u32 cSize, cSize
        payload bytes, then a flag byte — 0 marks a zstd stream, nonzero
        a record stored verbatim because compression did not shrink it
        (DBReader.cpp:511-538).  NOTE the index column holds the
        UNCOMPRESSED record length; the physical entry extent is
        4 + cSize + 1, so slicing must go by offset, not index length."""
        c_size = int(np.frombuffer(raw[off:off + 4].tobytes(),
                                   dtype=np.uint32)[0])
        payload = raw[off + 4:off + 4 + c_size].tobytes()
        flag_pos = off + 4 + c_size
        is_compressed = flag_pos < len(raw) and raw[flag_pos] == 0
        if not is_compressed:
            return payload
        import zstandard
        return zstandard.ZstdDecompressor().decompressobj() \
            .decompress(payload)

    @staticmethod
    def _read_mmseqs_data(db_path: str) -> np.ndarray:
        """Raw data bytes of a reference DB; multi-file DBs (db.0 .. db.N,
        per-thread writers left unmerged) are concatenated in order, which
        is how DBReader addresses them (global offsets)."""
        if os.path.exists(db_path):
            return np.fromfile(db_path, dtype=np.uint8)
        parts = []
        i = 0
        while os.path.exists(f"{db_path}.{i}"):
            parts.append(np.fromfile(f"{db_path}.{i}", dtype=np.uint8))
            i += 1
        if not parts:
            raise FileNotFoundError(db_path)
        return np.concatenate(parts)

    @staticmethod
    def read_mmseqs(db_path: str) -> "SeqDB":
        """Read a reference on-disk DB (data + .index, optional 4th
        wasExtended column) for golden tests."""
        entries = []
        with open(db_path + ".index") as fh:
            for line in fh:
                parts = line.split()
                key, off, ln = int(parts[0]), int(parts[1]), int(parts[2])
                we = int(parts[3]) if len(parts) > 3 else 0
                entries.append((key, off, ln, we))
        raw = SeqDB._read_mmseqs_data(db_path)
        compressed = SeqDB._read_dbtype(db_path) < 0  # bit 31 set
        seqs, keys, ext = [], [], []
        for key, off, ln, we in entries:
            if compressed:
                rec = np.frombuffer(SeqDB._decompress_entry(raw, off),
                                    dtype=np.uint8)
            else:
                rec = raw[off:off + ln]
            # records end with '\n\0' (sequences) or '\0' (results)
            end = len(rec)
            while end > 0 and rec[end - 1] in (0, 10):
                end -= 1
            seqs.append(bytes(rec[:end]))
            keys.append(key)
            ext.append(bool(we))
        return SeqDB.from_sequences(seqs, keys=np.array(keys, dtype=np.uint32),
                                    ext=np.array(ext, dtype=bool))

    def write_mmseqs(self, db_path: str, dbtype: int | None = None,
                     compressed: bool = False) -> None:
        """Write a reference-format on-disk DB (data + .index + .dbtype)
        that the reference binary's DBReader can mmap: records are
        '\\n\\0'-terminated, the 4-column index carries the wasExtended
        flag (DBWriter.cpp:415-424).

        `compressed=True` writes the `--compressed` entry format
        (DBWriter WRITER_COMPRESSED_MODE, DBWriter.cpp:274-392): each
        entry is u32 payloadSize + payload + flag byte, where the
        payload is a zstd level-3 stream of record+'\\n' (flag 0x00), or
        the raw bytes when the record is shorter than 60 (flag 0xFF,
        zstd struggles below that); the index keeps the UNCOMPRESSED
        length and .dbtype sets bit 31."""
        zc = None
        if compressed:
            import zstandard
            zc = zstandard.ZstdCompressor(level=3)
        with open(db_path, "wb") as fd, open(db_path + ".index", "w") as fi:
            off = 0
            for i in range(len(self)):
                body = self.seq_bytes(i).tobytes() + b"\n"
                if not compressed:
                    rec = body + b"\x00"
                    ln = len(rec)
                else:
                    # streaming frame like ZSTD_initCStream (no content
                    # size header); uncompressed length incl. null byte
                    if len(body) < 60:
                        payload, flag = body, b"\xff"
                    else:
                        co = zc.compressobj()
                        payload = co.compress(body) + co.flush()
                        flag = b"\x00"
                    rec = np.uint32(len(payload)).tobytes() + payload \
                        + flag
                    ln = len(body) + 1
                fd.write(rec)
                fi.write(f"{int(self.keys[i])}\t{off}\t{ln}\t"
                         f"{1 if self.ext[i] else 0}\n")
                off += len(rec)
        with open(db_path + ".dbtype", "wb") as ft:
            dt = np.uint32(dbtype if dbtype is not None else self.dbtype)
            if compressed:
                dt |= np.uint32(1 << 31)
            ft.write(dt.astype(np.uint32).tobytes())

    @staticmethod
    def read_mmseqs_records(db_path: str) -> dict[int, str]:
        """Read a reference result DB as {key: record-text} (for prefilter /
        alignment DB golden tests)."""
        out = {}
        with open(db_path + ".index") as fh:
            entries = [line.split() for line in fh]
        raw = SeqDB._read_mmseqs_data(db_path)
        compressed = SeqDB._read_dbtype(db_path) < 0
        rawb = raw.tobytes()
        for parts in entries:
            key, off, ln = int(parts[0]), int(parts[1]), int(parts[2])
            if compressed:
                rec = SeqDB._decompress_entry(raw, off)
            else:
                rec = rawb[off:off + ln]
            out[key] = rec.rstrip(b"\x00").decode("ascii")
        return out
