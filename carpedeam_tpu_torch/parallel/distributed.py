"""Multi-process distribution of the assembly pipeline.

Port of carpedeam_tpu/parallel/distributed.py.  The reference
distributes with MPI over a shared filesystem
(lib/mmseqs/src/commons/MMseqsMPI.{h,cpp}):

* kmermatcher: the 16-bit hash space is split into ranges, ranges are
  assigned round-robin over ranks (kmermatcher.cpp:636-664), every rank
  writes its sorted entry spill files, and rank 0 k-way merges them back
  into one globally sorted stream before the group/scan phase
  (mergeKmerFilesAndOutput, :957), so the distributed result is
  bit-identical to the single-node run;
* rescorediagonal: record ranges per rank (decomposeDomainByAminoAcid)
  with a rank-0 result merge (rescorediagonal.cpp:400-422).

Here, as in the JAX package, each process owns a share of the hash,
sequence and record ranges, and results cross between processes only
through files in a shared directory (`shard_dir`).  The process group
(`initialize`) is torch.distributed over gloo, and its only use is the
barrier: gloo, not NCCL, because NCCL refuses two ranks on one GPU
("Duplicate GPU detected") and the barrier carries no data.  The JAX
package's barrier, multihost_utils.sync_global_devices, is likewise only
a sync.  Across the devices of one process, parallel/mesh.py shards.

`kmermatcher_sharded` is the single-process form of the same contract
(compute shard entry tables independently, merge, group once).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .. import native
from ..io.seqdb import SeqDB
from ..kmer.matcher import (BIT63, _pref_from_scan,
                            extract_selected_kmers_batched, pref_from_entries)
from ..utils import subtimer
from .mesh import kmer_hash_ranges


def shards_for_process(n_shards: int, process_id: int,
                       num_processes: int) -> list[int]:
    """Round-robin shard assignment (kmermatcher.cpp:642-651)."""
    return [s for s in range(n_shards) if s % num_processes == process_id]


def _entry_order(ent: dict) -> np.ndarray:
    """The global sort key's permutation (kmer|b63 asc, seqLen desc, id
    asc, pos asc; kmermatcher.cpp:409-415)."""
    return np.lexsort((ent["pos"], ent["id"],
                       -ent["seq_len"].astype(np.int64),
                       ent["kmer"] | BIT63))


def extract_shard_entries(seqdb: SeqDB, k: int, kmers_per_sequence: int,
                          kmers_per_sequence_scale: float, hash_shift: int,
                          shard: int, n_shards: int) -> dict:
    """One hash-range shard's selected k-mer entries, pre-sorted by the
    global sort key (the reference's per-split spill file)."""
    lo, hi = kmer_hash_ranges(n_shards)[shard]
    ent = extract_selected_kmers_batched(
        seqdb, k, kmers_per_sequence, kmers_per_sequence_scale, hash_shift,
        hash_range=(lo, hi))
    order = _entry_order(ent)
    return {k_: v[order] for k_, v in ent.items()}


def merge_shard_entries(shards: list[dict]) -> dict:
    """Merge per-shard sorted entry tables back into one global order
    (mergeKmerFilesAndOutput analogue).  The hash ranges are disjoint but
    not contiguous in k-mer space, so a full merge by the global key is
    required; the merged multiset equals the single-shard table."""
    cat = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    order = _entry_order(cat)
    return {k: v[order] for k, v in cat.items()}


def kmermatcher_sharded(seqdb: SeqDB, k: int, kmers_per_sequence: int,
                        kmers_per_sequence_scale: float,
                        include_only_extendable: bool, hash_shift: int = 67,
                        n_shards: int = 4, cov_mode: int = 0,
                        cov_thr: float = 0.0):
    """Hash-range-sharded kmermatcher: per-shard extraction and sort, one
    merge, one group/scan (the native pref_from_entries, which groups the
    same entry multiset exactly as the JAX package's assign_groups and
    build_pref_db do).  Bit-identical to the unsharded stage."""
    shards = [extract_shard_entries(seqdb, k, kmers_per_sequence,
                                    kmers_per_sequence_scale, hash_shift,
                                    s, n_shards)
              for s in range(n_shards)]
    return pref_from_entries(seqdb, merge_shard_entries(shards),
                             include_only_extendable, cov_mode, cov_thr)


# ---------------------------------------------------------------- processes
def initialize(coordinator: str, num_processes: int,
               process_id: int) -> None:
    """Join the process group (the MMseqsMPI::init analogue):
    torch.distributed over gloo, rendezvous at tcp://`coordinator`
    (host:port), which rank 0 serves."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def process_barrier() -> None:
    """Cross-process barrier over the process group of `initialize`."""
    import torch.distributed as dist
    dist.barrier()


N_KRANGES = 64     # kmer-value ranges (phase A -> B routing)
N_CBUCKETS = 128   # centre-id buckets (phase B -> C routing)
_ENT_FIELDS = ("kmer", "id", "pos", "seq_len")


def _dump(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def _load(path: str):
    with open(path, "rb") as fh:
        return pickle.load(fh)


# ---- flat binary spill files (the reference's raw sorted spill files,
# kmermatcher.cpp:622-706: plain struct streams, no serialisation layer).
# One file per (rank, field) holding that rank's entries/pairs sorted by
# partition id, plus one small .npy of partition boundaries; readers
# np.memmap the span they own.
def _spill_flat(dirpath: str, name: str, rank: int, bounds: np.ndarray,
                **fields) -> None:
    np.save(os.path.join(dirpath, f"{name}_{rank}_bounds.npy"),
            np.asarray(bounds, dtype=np.int64))
    for f, a in fields.items():
        np.ascontiguousarray(a).tofile(
            os.path.join(dirpath, f"{name}_{rank}_{f}.bin"))


def _spill_bounds(dirpath: str, name: str, rank: int) -> np.ndarray:
    return np.load(os.path.join(dirpath, f"{name}_{rank}_bounds.npy"))


def _spill_map(dirpath: str, name: str, rank: int, field: str,
               dtype) -> np.ndarray:
    path = os.path.join(dirpath, f"{name}_{rank}_{field}.bin")
    if os.path.getsize(path) == 0:
        return np.zeros(0, dtype=dtype)
    return np.memmap(path, dtype=dtype, mode="r")


def _gather_spans(maps: list[np.ndarray], bounds: list[np.ndarray],
                  parts: range, out_dtype) -> np.ndarray:
    """Concatenate spans in (partition, source-rank) interleave order,
    the order that reproduces the single-process stream exactly (within a
    partition, source ranks own ascending sequence ranges)."""
    total = sum(int(b[parts.stop] - b[parts.start]) for b in bounds)
    out = np.empty(total, dtype=out_dtype)
    o = 0
    for p in parts:
        for m, b in zip(maps, bounds):
            lo, hi = int(b[p]), int(b[p + 1])
            out[o:o + hi - lo] = m[lo:hi]
            o += hi - lo
    return out


def _contiguous_partition(counts: np.ndarray, world: int) -> list[int]:
    """Deterministic contiguous split of len(counts) slots into `world`
    parts balanced by cumulative count; returns boundary slot indices
    (len world+1)."""
    cum = np.concatenate([[0], np.cumsum(counts.astype(np.float64))])
    total = cum[-1]
    bounds = [0]
    for r in range(1, world):
        bounds.append(int(np.searchsorted(cum, total * r / world)))
    bounds.append(len(counts))
    for r in range(1, world + 1):   # keep boundaries monotone
        if bounds[r] < bounds[r - 1]:
            bounds[r] = bounds[r - 1]
    return bounds


def _gather_field(shard_dir: str, name: str, world: int, field: str,
                  dtype, bounds: list, parts: range, out_dtype):
    return _gather_spans([_spill_map(shard_dir, name, src, field, dtype)
                          for src in range(world)], bounds, parts, out_dtype)


def process_kmermatcher(seqdb: SeqDB, params_tuple, shard_dir: str,
                        process_id: int, num_processes: int,
                        barrier=None, local: bool = False):
    """Fully distributed kmermatcher (no rank-0 serial phase):

    * phase A: each rank extracts ITS OWN sequence range (equal residue
      split) and spills the entries partitioned into N_KRANGES
      contiguous k-mer value ranges (kmer u64 + id u32 + pos u32; seq_len
      re-derives from the global lengths on read);
    * phase B: ranks take contiguous k-mer ranges balanced by entry
      count, gather their spans in (range, source-rank) order (which
      reproduces the single-process entry order, since source ranks own
      ascending sequence ranges), run the native group-walk pair
      emission, and spill pairs into N_CBUCKETS contiguous centre-id
      buckets (pk1 u64 + pk2 u32 + fwd u8);
    * phase C: ranks take contiguous centre buckets balanced by pair
      count, gather spans in (bucket, source-rank) order, and run the
      native stable pair sort and result scan over their centre span.

    With `local=True` (the pipeline's mode) each rank returns ONLY its
    own centre span as `(PrefDB, (qlo, qhi))`: the downstream stages are
    per-query and consume the local slice.  With local=False every rank
    assembles and returns the identical full PrefDB.  Bit-identical to
    the single-process stage (the concatenation of the local slices
    equals the full PrefDB up to empty-group placement, and every
    per-query group is exact).  `barrier` blocks until all ranks
    arrive."""
    k, kps, scale, ioe, hash_shift = params_tuple
    os.makedirs(shard_dir, exist_ok=True)
    world = num_processes
    n_seq = len(seqdb)
    if world <= 1:
        ent = extract_selected_kmers_batched(seqdb, k, kps, scale,
                                             hash_shift)
        pref = pref_from_entries(seqdb, ent, ioe)
        return (pref, (0, n_seq)) if local else pref

    # ---- phase A: extract own sequence range, spill by k-mer range ----
    with subtimer("km.phaseA"):
        seq_bounds = _contiguous_partition(seqdb.lengths, world)
        lo, hi = seq_bounds[process_id], seq_bounds[process_id + 1]
        if hi > lo:
            sub_db = SeqDB(seqdb.data, seqdb.offsets[lo:hi],
                           seqdb.lengths[lo:hi], seqdb.keys[lo:hi],
                           seqdb.ext[lo:hi], None, seqdb.dbtype)
            ent = extract_selected_kmers_batched(sub_db, k, kps, scale,
                                                 hash_shift)
            ent["id"] = ent["id"] + lo
        else:
            ent = {f: np.zeros(0, dtype=np.uint64 if f == "kmer" else
                               np.int64 if f == "id" else np.int32)
                   for f in _ENT_FIELDS}
        # k-mer range id from the top bits of the 2k-bit canonical value
        # (bit 63 is the strand flag; the payload is only 2k bits wide)
        shift = max(0, 2 * k - 6)
        kr = (np.asarray(ent["kmer"], dtype=np.uint64)
              & np.uint64((1 << 63) - 1)) >> np.uint64(shift)
        kr = np.minimum(kr, N_KRANGES - 1)
        order = np.argsort(kr, kind="stable")
        bounds = np.searchsorted(kr[order], np.arange(N_KRANGES + 1))
        _spill_flat(shard_dir, "entA", process_id, bounds,
                    kmer=ent["kmer"][order],
                    id=ent["id"][order].astype(np.uint32),
                    pos=ent["pos"][order].astype(np.uint32))
        del ent, kr, order
    with subtimer("km.barrierA"):
        barrier()

    # ---- phase B: pair emission over contiguous k-mer ranges ----------
    with subtimer("km.phaseB"):
        a_bounds = [_spill_bounds(shard_dir, "entA", src)
                    for src in range(world)]
        totals = np.sum([np.diff(b) for b in a_bounds], axis=0)
        kbounds = _contiguous_partition(totals, world)
        my_ranges = range(kbounds[process_id], kbounds[process_id + 1])
        ids64 = _gather_field(shard_dir, "entA", world, "id", np.uint32,
                              a_bounds, my_ranges, np.int64)
        ent_b = {
            "kmer": _gather_field(shard_dir, "entA", world, "kmer",
                                  np.uint64, a_bounds, my_ranges, np.uint64),
            "id": ids64,
            "pos": _gather_field(shard_dir, "entA", world, "pos", np.uint32,
                                 a_bounds, my_ranges, np.int32),
            "seq_len": seqdb.lengths[ids64].astype(np.int32),
        }
        pk1, pk2, fwd = native.kmer_emit_pairs(ent_b, ioe)
        del ent_b, ids64
        # centre buckets (contiguous id ranges)
        per = max(1, -(-n_seq // N_CBUCKETS))
        cb = (pk1 >> np.uint64(32)).astype(np.int64) // per
        orderp = np.argsort(cb, kind="stable")
        pb = np.searchsorted(cb[orderp], np.arange(N_CBUCKETS + 1))
        _spill_flat(shard_dir, "pairB", process_id, pb,
                    pk1=pk1[orderp], pk2=pk2[orderp], fwd=fwd[orderp])
        del pk1, pk2, fwd, cb, orderp
    with subtimer("km.barrierB"):
        barrier()

    # ---- phase C: stable pair sort + result scan per centre span ------
    with subtimer("km.phaseC"):
        b_bounds = [_spill_bounds(shard_dir, "pairB", src)
                    for src in range(world)]
        ptotals = np.sum([np.diff(b) for b in b_bounds], axis=0)
        cbounds = _contiguous_partition(ptotals, world)
        my_buckets = range(cbounds[process_id], cbounds[process_id + 1])
        p1, p2, fw = (_gather_field(shard_dir, "pairB", world, f, dt,
                                    b_bounds, my_buckets, dt)
                      for f, dt in (("pk1", np.uint64), ("pk2", np.uint32),
                                    ("fwd", np.uint8)))
        scan = native.kmer_pairs_to_pref(p1, p2, fw, seqdb.keys)
        del p1, p2, fw
        qlo = min(n_seq, cbounds[process_id] * per)
        qhi = min(n_seq, cbounds[process_id + 1] * per)
        if local:
            # each rank keeps only its centre span; downstream stages are
            # per-query, so nothing more ever crosses ranks
            return _pref_from_scan(seqdb, scan, row_range=(qlo, qhi)), \
                (qlo, qhi)
        _dump(os.path.join(shard_dir, f"scanC_{process_id}.pkl"), scan)
    with subtimer("km.barrierC"):
        barrier()

    # ---- assemble the full PrefDB on every rank -----------------------
    with subtimer("km.assemble"):
        parts = [_load(os.path.join(shard_dir, f"scanC_{src}.pkl"))
                 for src in range(world)]
        row_off = np.cumsum([0] + [len(s[0]) for s in parts[:-1]])
        merged = tuple(np.concatenate([s[i] for s in parts])
                       for i in range(4)) + (
            np.concatenate([s[4] + off for s, off in zip(parts, row_off)])
            .astype(np.int64),
            np.concatenate([s[5] for s in parts]).astype(np.int64))
        return _pref_from_scan(seqdb, merged)


def decompose_by_residue_count(lengths: np.ndarray,
                               num_processes: int) -> list[tuple[int, int]]:
    """Util::decomposeDomainByAminoAcid analogue: split the query index
    range into `num_processes` contiguous chunks of roughly equal total
    residue count (rescorediagonal.cpp:400-422's domain decomposition)."""
    total = int(lengths.sum())
    target = total / max(num_processes, 1)
    bounds = []
    start = 0
    acc = 0
    for i, L in enumerate(lengths):
        acc += int(L)
        if acc >= target * (len(bounds) + 1) \
                and len(bounds) < num_processes - 1:
            bounds.append((start, i + 1))
            start = i + 1
    bounds.append((start, len(lengths)))
    while len(bounds) < num_processes:
        bounds.append((len(lengths), len(lengths)))
    return bounds


def rescorediagonal_range(seqdb: SeqDB, pref, seq_id_thr: float,
                          q_range: tuple[int, int], eval_thr: float = 0.001,
                          aln_len_thr: int = 0):
    """Rescore only the prefilter records of queries [q_range), one
    process's share.  Per-query work is independent, so concatenating the
    per-range results in range order is bit-identical to the full run
    (the reference's rank-0 DBWriter::mergeResults contract)."""
    from ..aligndb import PrefDB
    from ..stages.rescorediagonal import rescorediagonal

    lo, hi = q_range
    s, e = int(pref.starts[lo]), int(pref.starts[hi])
    sub = PrefDB(qkey=pref.qkey[s:e], tkey=pref.tkey[s:e],
                 score=pref.score[s:e], diag=pref.diag[s:e],
                 starts=pref.starts[lo:hi + 1] - pref.starts[lo],
                 qkeys=pref.qkeys[lo:hi],
                 qext=pref.qext[lo:hi] if pref.qext is not None else None)
    return rescorediagonal(seqdb, sub, seq_id_thr, eval_thr, aln_len_thr)


def merge_aln_ranges(parts: list):
    """Concatenate per-range alignment DBs in range order."""
    from ..aligndb import ALN_FIELDS, AlnDB

    qkey = np.concatenate([p.qkey for p in parts])
    cols = {name: np.concatenate([p.cols[name] for p in parts])
            for name, _ in ALN_FIELDS}
    starts = [np.zeros(1, dtype=np.int64)]
    off = 0
    for p in parts:
        starts.append(p.starts[1:] + off)
        off += int(p.starts[-1])
    return AlnDB(qkey, cols, np.concatenate(starts),
                 np.concatenate([p.qkeys for p in parts]))
