"""Pipeline-level multi-process distribution (the `--mpi-runner` role).

Port of carpedeam_tpu/parallel/driver.py.  The reference drives the
whole binary under mpirun (lib/mmseqs/src/commons/Parameters.cpp:150
RUNNER); the two stages with MPI hooks split their work by rank
(kmermatcher by 16-bit hash ranges, kmermatcher.cpp:636-664;
rescorediagonal by query record ranges, rescorediagonal.cpp:400-422),
with results merged through the shared filesystem.  Here every process
runs `ancient_assemble` with the same arguments plus
CARPEDEAM_RANK/CARPEDEAM_WORLD (and optionally CARPEDEAM_COORD
host:port): the kmermatcher splits by k-mer and centre ranges, each rank
rescores and corrects its own query range, read extension and contig
merging split by query range too, and every rank assembles the identical
merged SeqDB after each stage.  The output is byte-identical to the
single-process run (tests/test_torch_parallel.py).
"""
from __future__ import annotations

import os
import shutil
import time
import uuid

import numpy as np

from ..io.seqdb import SeqDB
from ..utils import subtimer
from . import distributed as D


class DistContext:
    """Process-group context for the distributed pipeline.

    `barrier()` blocks until every rank arrives.  With a coordinator the
    barrier is torch.distributed's (gloo); without one (one host, a plain
    multi-process launch) a shared-filesystem counter barrier in
    `shard_dir` is used, and `from_env` makes `shard_dir` a directory of
    this run alone (`_file_session`), so no marker or spill file that an
    earlier or crashed run left in the same TMP_DIR is ever read."""

    def __init__(self, rank: int, world: int, shard_dir: str,
                 use_group: bool = False):
        self.rank = rank
        self.world = world
        self.shard_dir = shard_dir
        self._use_group = use_group
        self._epoch = 0
        os.makedirs(shard_dir, exist_ok=True)

    @classmethod
    def from_env(cls, dist_dir: str) -> "DistContext | None":
        world = int(os.environ.get("CARPEDEAM_WORLD", "1"))
        if world <= 1:
            return None
        rank = int(os.environ.get("CARPEDEAM_RANK", "0"))
        coord = os.environ.get("CARPEDEAM_COORD")
        if coord:
            # every spill file is written before the barrier that
            # precedes its reading, so files of an earlier run in
            # dist_dir are overwritten first
            D.initialize(coord, world, rank)
            return cls(rank, world, dist_dir, use_group=True)
        return cls(rank, world, os.path.join(
            dist_dir, _file_session(dist_dir, rank, world)))

    def barrier(self, timeout: float = 600.0) -> None:
        if self._use_group:
            D.process_barrier()
            return
        # shared-filesystem counter barrier (one marker per rank/epoch)
        self._epoch += 1
        me = os.path.join(self.shard_dir,
                          f"barrier_{self._epoch}.{self.rank}")
        with open(me, "w"):
            pass
        deadline = time.monotonic() + timeout
        while True:
            n = sum(os.path.exists(os.path.join(
                self.shard_dir, f"barrier_{self._epoch}.{r}"))
                for r in range(self.world))
            if n == self.world:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {self.rank}: barrier {self._epoch} timed out "
                    f"({n}/{self.world})")
            time.sleep(0.02)


def _file_session(dist_dir: str, rank: int, world: int,
                  timeout: float = 600.0) -> str:
    """The name of a fresh run directory that every rank of this run
    agrees on, through files in `dist_dir`: rank r > 0 writes a new nonce
    to join.<r>; rank 0 removes everything else that earlier runs left,
    then publishes `session` (its own nonce, then the rank nonces it
    read), again whenever a join file changes (it may first read one an
    earlier run left).  A rank takes the session that lists its own nonce
    and acknowledges it in ack.<r>; rank 0 returns once every rank has."""
    os.makedirs(dist_dir, exist_ok=True)
    me = uuid.uuid4().hex
    deadline = time.monotonic() + timeout

    def path(name):
        return os.path.join(dist_dir, name)

    def wait():
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: no session in {dist_dir}")
        time.sleep(0.02)

    if rank == 0:
        for name in os.listdir(dist_dir):
            if not name.startswith("join."):
                p = path(name)
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        listed = None
        while True:
            nonces = [_read(path(f"join.{r}")) for r in range(1, world)]
            if None not in nonces and nonces != listed:
                _write(path("session"), " ".join([me] + nonces))
                listed = nonces
            if listed is not None and all(
                    _read(path(f"ack.{r}")) == me for r in range(1, world)):
                return me
            wait()
    _write(path(f"join.{rank}"), me)
    while True:
        words = (_read(path("session")) or "").split()
        if len(words) == world and words[rank] == me:
            _write(path(f"ack.{rank}"), words[0])
            return words[0]
        wait()


def _read(path: str) -> str | None:
    try:
        with open(path) as fh:
            return fh.read()
    except FileNotFoundError:
        return None


def _write(path: str, text: str) -> None:
    """Write whole or not at all: readers never see a partial file."""
    with open(path + ".tmp", "w") as fh:
        fh.write(text)
    os.replace(path + ".tmp", path)


def dist_kmermatcher(dist: DistContext, seqdb, k: int, kps: int,
                     scale: float, only_ext: bool, hash_shift: int,
                     step: int):
    """Distributed kmermatcher, range-local: each rank computes and KEEPS
    only its own centre span of the prefilter result (the downstream
    per-query stages consume exactly that span).  Returns (pref_local,
    (qlo, qhi))."""
    sub = os.path.join(dist.shard_dir, f"km_{step}")
    with subtimer("dist.km_process"):
        return D.process_kmermatcher(
            seqdb, (k, kps, scale, only_ext, hash_shift), sub, dist.rank,
            dist.world, barrier=dist.barrier, local=True)


def dist_rescorediagonal(dist: DistContext, seqdb, pref_local, seq_id_thr,
                         eval_thr, aln_len_thr, step: int):
    """Range-local rescorediagonal: the rank's prefilter slice rescored
    in memory by the host oracle (per-query work is independent: no
    exchange, no spill, no merge).  Returns the LOCAL AlnDB slice."""
    from ..stages.rescorediagonal import rescorediagonal
    with subtimer("dist.rescore_range"):
        return rescorediagonal(seqdb, pref_local, seq_id_thr, eval_thr,
                               aln_len_thr)


def dist_apply_by_query_range(dist: DistContext, step: int, tag: str,
                              seqdb, aln, apply_fn):
    """Distribute a per-query SeqDB -> SeqDB stage (correction,
    read_assembly, contig_merge: each query's output depends only on its
    own alignment group and the FULL input DB) across ranks:

      * `aln` is this rank's own query slice (the range-local pipeline:
        the centre span of dist_kmermatcher);
      * each rank runs the stage on its slice (queries outside it pass
        through untouched) and spills only the rows whose bytes or ext
        flag changed;
      * every rank assembles the identical merged result (ranges are
        disjoint, so no row conflicts)."""
    qrows = seqdb.lookup_keys(aln.qkeys).astype(np.int64)
    sub = os.path.join(dist.shard_dir, f"{tag}_{step}")
    os.makedirs(sub, exist_ok=True)
    changed: dict[int, tuple[bytes, bool]] = {}
    with subtimer(f"dist.apply_{tag}"):
        if len(qrows):
            out = apply_fn(seqdb, aln)
            for r in qrows:
                r = int(r)
                nb = bytes(out.seq_bytes(r))
                ne = bool(out.ext[r])
                if nb != bytes(seqdb.seq_bytes(r)) \
                        or ne != bool(seqdb.ext[r]):
                    changed[r] = (nb, ne)
        D._dump(os.path.join(sub, f"part_{dist.rank}.pkl"), changed)
    with subtimer(f"dist.apply_{tag}_barrier"):
        dist.barrier()
    merged: dict[int, tuple[bytes, bool]] = {}
    for r in range(dist.world):
        merged.update(D._load(os.path.join(sub, f"part_{r}.pkl")))
    if not merged:
        return seqdb
    n = len(seqdb)
    new_lengths = seqdb.lengths.astype(np.int64).copy()
    new_ext = seqdb.ext.copy()
    parts = []
    prev = 0
    total_in = int(seqdb.offsets[-1] + seqdb.lengths[-1]) if n else 0
    for i in sorted(merged):
        o = int(seqdb.offsets[i])
        if o > prev:
            parts.append(seqdb.data[prev:o])
        nb, ne = merged[i]
        rec = np.frombuffer(nb, dtype=np.uint8)
        parts.append(rec)
        new_lengths[i] = len(rec)
        new_ext[i] = ne
        prev = o + int(seqdb.lengths[i])
    if total_in > prev:
        parts.append(seqdb.data[prev:total_in])
    new_data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    new_offsets = np.concatenate([[0], np.cumsum(new_lengths[:-1])]) \
        .astype(np.int64)
    return SeqDB(new_data, new_offsets, new_lengths, seqdb.keys.copy(),
                 new_ext, seqdb.headers, seqdb.dbtype)
