"""Assembly pipeline drivers: nuclassemble and ancient_assemble, on the
card.

Port of carpedeam_tpu/pipeline.py: the same iterative loop (5 read-phase
and 5 contig-phase iterations for ancient_assemble, then linclust and
FASTA output), the same checkpoints and the same Params.  Per iteration
the kmermatcher runs on the host (native C++) while the sequence planes
stream to the device; rescorediagonal, correction and the read-phase
extension scoring run the CUDA kernels (ops/*_cuda.py) on `device`
("cuda", the default), or the same drivers with the kernels' plain
PyTorch versions when the caller passes device="cpu".  `--use-device 0`
runs the host oracles instead, `1` the tensor programs and `mesh` the
same programs sharded over a list of devices (parallel/mesh.py), as the
JAX package does (`_pick_stage_impls`).  With `dist` (parallel/driver.py)
the loop runs as one rank of a process group.
"""
from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import torch

from .damage import DamageModel
from .io.seqdb import SeqDB
from .kmer.matcher import kmermatcher
from .ops.correction_cuda import correction_cuda
from .ops.correction_device import correction_device_stage
from .ops.kmer_device import kmermatcher_device
from .ops.rescore_cuda import rescorediagonal_cuda
from .ops.rescore_device import rescorediagonal_device
from .parallel.driver import (dist_apply_by_query_range, dist_kmermatcher,
                              dist_rescorediagonal)
from .params import Params, parse_byte_size
from .stages.contig_merge import contig_merge
from .stages.correction import correction
from .stages.cyclecheck import cyclecheck
from .stages.read_assembly import read_assembly
from .stages.rescorediagonal import rescorediagonal
from .utils import (StageTimer, bucket_len, coverage_add, log_info,
                    resolve_device)


class Checkpointer:
    """Stage-granular checkpoints: each stage saves under tmp/<name> and a
    <name>.done marker (the reference's notExists/.done contract)."""

    def __init__(self, tmp_dir: str | None):
        self.tmp = tmp_dir
        if tmp_dir:
            os.makedirs(tmp_dir, exist_ok=True)

    def path(self, name):
        return os.path.join(self.tmp, name) if self.tmp else None

    def done(self, name):
        return self.tmp and os.path.exists(self.path(name) + ".done")

    def mark(self, name):
        if self.tmp:
            with open(self.path(name) + ".done", "w"):
                pass

    def run(self, name, fn, loader, saver):
        """Run `fn` unless checkpointed; (loader/saver)(prefix)."""
        if self.done(name):
            return loader(self.path(name))
        result = fn()
        if self.tmp:
            saver(result, self.path(name))
            self.mark(name)
        return result


def _pick_kmermatcher(params: Params, device):
    """kmermatcher routing, the counterpart of carpedeam_tpu/pipeline.py::
    _pick_kmermatcher.  CARPEDEAM_KMER_DEVICE=1 runs the device
    kmermatcher (ops/kmer_device.py) on `device` (the CUDA kernels on the
    card, their plain versions on the CPU); "auto" and "0" keep the host
    path (native C++), as the JAX package's "auto" does.  The device path
    gives way to the host path only where the JAX package's does: its
    packing budget (2^21 sequences, 2^19 bases) raises ValueError, which
    is logged and counted (coverage "kmermatcher").  --split-memory-limit
    caps the host extraction's working set like the reference caps its
    k-mer array splits (kmermatcher.cpp:615-624): ~50 bytes of temporary
    window state per residue per block."""
    mode = os.environ.get("CARPEDEAM_KMER_DEVICE", "auto")
    limit = parse_byte_size(params.split_memory_limit) or 0
    mbr = max(limit // 50, 1 << 20) if limit else None
    dev = resolve_device(device) if mode == "1" else None

    def km(seqdb, k, kps, scale, only_ext, hash_shift=67,
           cov_mode=0, cov_thr=0.0):
        if dev is not None:
            try:
                pref = kmermatcher_device(seqdb, k, kps, scale, only_ext,
                                          hash_shift, cov_mode, cov_thr,
                                          device=dev)
                coverage_add("kmermatcher", 1, 0)
                return pref
            except ValueError as e:     # the packing budget
                log_info(f"kmermatcher: {e}; host path")
                coverage_add("kmermatcher", 0, 1)
        return kmermatcher(seqdb, k, kps, scale, only_ext, hash_shift,
                           cov_mode, cov_thr, max_block_residues=mbr)
    return km


def _pick_stage_impls(use_device: str, device, mesh_devices=None):
    """(rescore_fn, correction_fn, device or None, planes_out) for
    `--use-device`, the counterpart of carpedeam_tpu/pipeline.py::
    _pick_stage_impls.

    "0" runs the host oracles (native C++): no planes, no card, so it
    runs on a machine without one.  "auto" and "pallas" run the CUDA
    kernels on `device` (their plain PyTorch versions when `device` is
    the CPU); their correction can derive the corrected planes on the
    device (`planes_out`).  "1" runs the JAX package's tensor programs
    for accelerators that are not TPUs (ops/rescore_device.py,
    ops/correction_device.py) on `device`.  "mesh" shards those programs
    over `make_mesh(mesh_devices)`: every visible card, or the CPU alone
    when `device` is the CPU and no list is given; its stages pack their
    own planes, so none are prefetched (carpedeam_tpu/pipeline.py:84-91).
    """
    if use_device == "0":
        return rescorediagonal, correction, None, False
    if use_device == "mesh":
        from .parallel.mesh import (correction_sharded, make_mesh,
                                    rescorediagonal_sharded)
        if mesh_devices is None and torch.device(device).type == "cpu":
            mesh_devices = ["cpu"]
        mesh = make_mesh(mesh_devices)
        return (rescorediagonal_sharded(mesh), correction_sharded(mesh),
                None, False)
    dev = resolve_device(device)
    if use_device == "1":
        return (partial(rescorediagonal_device, device=dev),
                partial(correction_device_stage, device=dev), dev, False)
    return (partial(rescorediagonal_cuda, device=dev),
            partial(correction_cuda, device=dev), dev, True)


def planes_prefetch(db: SeqDB, dev):
    """The shared sequence planes of `db` on `dev`, packed and uploaded
    asynchronously (ops/planes.PlanesPrefetch), or None when the stages
    take none: `dev` None (the host oracles, the mesh stages) or an empty
    DB.  Plane width is capped at 512: the short-read bulk stays
    device-resident in every phase; stages route records touching longer
    sequences to wider per-level planes or the host oracles."""
    if dev is None or not len(db):
        return None
    from .ops.planes import PlanesPrefetch
    max_len = bucket_len(min(512, int(db.lengths.max())))
    return PlanesPrefetch(db, max_len=max_len, device=dev)


def shared_from(pf) -> dict:
    """{"planes", "lengths"} keyword arguments of the device stages from a
    planes_prefetch result ({} for None)."""
    if pf is None:
        return {}
    planes, lengths = pf.get()
    return {"planes": planes, "lengths": lengths}


def nuclassemble(reads: SeqDB, params: Params, damage: DamageModel,
                 tmp_dir: str | None = None, progress=None, device="cuda",
                 timer: StageTimer | None = None, dist=None,
                 mesh_devices=None):
    """The inner assembly loop (data/nuclassemble.sh:97-233).

    Returns (result SeqDB, cycle_all keys set, source SeqDB).  `device`
    is "cuda" (default; raises without a card) or "cpu", and is not read
    under `params.use_device == "0"` (the host oracles); `timer`
    (optional) collects the per-stage wall times; `mesh_devices` is the
    device list of `--use-device mesh` (parallel/mesh.make_mesh; under
    `dist`, `device` alone unless a list is given).

    `dist` (parallel/driver.DistContext) runs the loop as one rank of a
    process group, as carpedeam_tpu/pipeline.py:221-397 does: the
    kmermatcher splits by k-mer and centre ranges and keeps the rank's
    centre span; the rank rescores that span with the host oracle and
    runs correction (the `--use-device` pick, on `device`), read
    extension (host scoring: no planes) and contig merging on it; every
    rank assembles the identical merged DB after each stage (requires a
    shared `tmp_dir`).  Only rank 0 writes checkpoints; the ranks meet at
    a barrier after every iteration.  Byte-identical to the
    single-process run.
    """
    if dist is not None and not tmp_dir:
        raise ValueError("distributed mode requires a shared tmp_dir")
    if dist is not None and mesh_devices is None:
        # a rank shards over its own device, cuda:(rank % cards) under
        # the CLI, not over every card
        mesh_devices = [device]
    rescore_fn, correction_fn, dev, planes_out = _pick_stage_impls(
        params.use_device, device, mesh_devices)
    if tmp_dir:
        # key the checkpoint dir by the parameter + input fingerprint
        # (par.hashParameter, GuidedNuclassembler.cpp:106-110): re-running
        # with ANY changed flag or different input lands in a fresh
        # subdirectory and can never resume stale stage results
        tmp_dir = os.path.join(
            tmp_dir, "p" + params.hash(len(reads),
                                       int(reads.lengths.sum())))
    ck = Checkpointer(tmp_dir)
    log = progress or (lambda *_: None)
    kmermatcher_fn = _pick_kmermatcher(params, device)

    def _planes_prefetch(db):
        """Start the per-iteration plane pack + H2D before the (host)
        kmermatcher runs; the copy overlaps the k-mer scan and
        `shared_from` collects the finished planes.  The ranks of a group
        take no planes."""
        return None if dist is not None else planes_prefetch(db, dev)

    def _shared_planes(db):
        """Pack + upload the sequence planes once; the device stages then
        reuse the same device-resident tensors."""
        return shared_from(_planes_prefetch(db))
    if timer is None:
        timer = StageTimer(
            log if (params.verbosity >= 4
                    or os.environ.get("CARPEDEAM_SUBTIMING", "0") != "0")
            else None)
    cur = reads
    cycle_all: dict[int, bytes] = {}   # accumulated circular contigs
    cycle_ext: dict[int, bool] = {}

    def _restore(step, read_phase, name):
        nonlocal cur
        cur = SeqDB.load(ck.path(name))
        if not read_phase and ck.done(f"cycle_{step}"):
            cyc = SeqDB.load(ck.path(f"cycle_{step}"))
            for j in range(len(cyc)):
                cycle_all[int(cyc.keys[j])] = bytes(cyc.seq_bytes(j))
                cycle_ext[int(cyc.keys[j])] = bool(cyc.ext[j])
            keep = ~np.isin(cur.keys, cyc.keys)
            cur = cur.select(np.nonzero(keep)[0])

    loop_t0 = time.perf_counter()
    for step in range(params.num_iterations):
        iter_t0 = time.perf_counter()
        read_phase = step < params.num_iterations_reads
        name = f"assembly_{'reads' if read_phase else 'contigs'}_{step}"
        if ck.done(name):
            _restore(step, read_phase, name)
            log(f"step {step}: restored from checkpoint")
            continue

        # the plane pack + upload streams while the host k-mer scan runs
        planes_pf = _planes_prefetch(cur)
        k = params.kmer_size_reads if read_phase \
            else params.kmer_size_contigs
        only_ext = params.include_only_extendable_reads if read_phase \
            else params.include_only_extendable_contigs
        seq_id = params.seq_id_thr if read_phase \
            else params.corr_contig_seq_id
        with timer.time(f"kmermatcher_{step}"):
            if dist is None:
                pref = kmermatcher_fn(cur, k, params.kmers_per_sequence,
                                      params.kmers_per_sequence_scale,
                                      only_ext, params.hash_shift)
            else:
                # range-local: this rank's centre span only; rescore,
                # correction and extension consume the same slice, and
                # only changed sequence rows cross ranks
                pref, _ = dist_kmermatcher(
                    dist, cur, k, params.kmers_per_sequence,
                    params.kmers_per_sequence_scale, only_ext,
                    params.hash_shift, step)
        shared = shared_from(planes_pf)
        with timer.time(f"rescorediagonal_{step}"):
            if dist is None:
                aln = rescore_fn(cur, pref, seq_id, params.eval_thr,
                                 params.aln_len_thr, **shared)
            else:
                aln = dist_rescorediagonal(dist, cur, pref, seq_id,
                                           params.eval_thr,
                                           params.aln_len_thr, step)

        def per_query(tag, db, fn):
            """fn(db, aln); under `dist`, over this rank's query span
            with the changed rows merged across ranks."""
            if dist is None:
                return fn(db, aln)
            return dist_apply_by_query_range(dist, step, tag, db, aln, fn)

        with timer.time(f"correction_{step}"):
            ext_pro = None
            corr_shared = None
            if read_phase and shared and planes_out:
                # corrected planes derive on the device from the
                # correction kernel's own output (no re-pack or
                # re-upload), and the correction pull is DEFERRED:
                # the extension stage's first device pass dispatches
                # against the derived planes while the corrected
                # bytes still stream to the host
                corr_fin, corr_shared = correction_fn(
                    cur, aln, damage, params.corr_reads_ry_seq_id,
                    params.seq_id_thr, return_planes=True, defer=True,
                    **shared)
                if corr_shared is not None and not params.ancient_unsafe:
                    from .ops.extension_batch import ext_prologue
                    ext_pro = ext_prologue(cur, aln, corr_shared["planes"],
                                           corr_shared["lengths"])
                corr = corr_fin()
            else:
                corr = per_query("corr", cur, lambda db, a: correction_fn(
                    db, a, damage, params.corr_reads_ry_seq_id, seq_id,
                    **shared))
        if read_phase:
            with timer.time(f"read_assembly_{step}"):
                # extension scores run over the CORRECTED sequences: the
                # device-derived corrected planes serve when available,
                # else pack fresh ones
                nxt = per_query("ext", corr, lambda db, a: read_assembly(
                    db, a, damage, params.seq_id_thr, params.ry_seq_id_thr,
                    params.likelihood_threshold, params.random_align_penal,
                    params.excess_penal, params.max_seq_len,
                    params.ancient_unsafe, params.min_cov_safe,
                    prologue=ext_pro,
                    **(corr_shared if corr_shared is not None
                       else _shared_planes(db))))
        else:
            with timer.time(f"contig_merge_{step}"):
                nxt = per_query("merge", corr, lambda db, a: contig_merge(
                    db, a, damage, params.merge_seq_id_thr,
                    params.ry_seq_id_thr, params.max_seq_len,
                    params.ancient_unsafe, params.min_cov_safe))

        writes = ck.tmp and (dist is None or dist.rank == 0)
        if writes:
            nxt.save(ck.path(name), compressed=bool(params.compressed))
            ck.mark(name)
        log(f"step {step}: {'reads' if read_phase else 'contigs'} "
            f"n={len(nxt)} extended={int(nxt.ext.sum())}")
        cur = nxt

        if not read_phase and params.cycle_check:
            cyc, none_cyc = cyclecheck(cur, k=22, chop=params.chop_cycle,
                                       max_seq_len=params.max_seq_len)
            if writes:
                cyc.save(ck.path(f"cycle_{step}"),
                         compressed=bool(params.compressed))
                ck.mark(f"cycle_{step}")
            if len(cyc):
                for j in range(len(cyc)):
                    cycle_all[int(cyc.keys[j])] = bytes(cyc.seq_bytes(j))
                    cycle_ext[int(cyc.keys[j])] = bool(cyc.ext[j])
                log(f"step {step}: {len(cyc)} circular contigs set aside")
                cur = none_cyc
        if dist is not None:
            dist.barrier()
        # per-iteration progress + ETA (Debug::Progress analogue; ETA
        # scales the mean iteration cost over the remaining steps)
        done_n = step + 1
        elapsed = time.perf_counter() - loop_t0
        eta = elapsed / done_n * (params.num_iterations - done_n)
        log(f"iteration {done_n}/{params.num_iterations} "
            f"({'reads' if read_phase else 'contigs'}) "
            f"{time.perf_counter() - iter_t0:.1f}s  "
            f"elapsed {elapsed:.1f}s  ETA {eta:.1f}s")

    # EPILOGUE (nuclassemble.sh:201-233)
    # RESULT = last contig assembly minus cycles, plus all accumulated cycles
    if cycle_all:
        seqs = [cur.seq_bytes(j) for j in range(len(cur))]
        keys = list(cur.keys)
        ext = list(cur.ext)
        for k_, s in cycle_all.items():
            seqs.append(np.frombuffer(s, dtype=np.uint8))
            keys.append(k_)
            ext.append(cycle_ext[k_])
        result = SeqDB.from_sequences([bytes(s) for s in seqs],
                                      keys=np.array(keys, dtype=np.uint32),
                                      ext=np.array(ext, dtype=bool))
    else:
        result = cur

    # only-assembled filter: output length strictly greater than source
    src_len = {int(reads.keys[j]): int(reads.lengths[j])
               for j in range(len(reads))}
    keep = [j for j in range(len(result))
            if int(result.lengths[j]) > src_len.get(int(result.keys[j]), -1)
            and int(result.lengths[j]) > params.min_contig_len - 1]
    result = result.select(np.array(keep, dtype=np.int64)) if keep \
        else SeqDB.from_sequences([])
    cycle_keys = set(cycle_all.keys()) & set(int(k) for k in result.keys)
    return result, cycle_keys, reads


def ancient_assemble(reads: SeqDB, params: Params, damage: DamageModel,
                     out_fasta: str | None = None, tmp_dir: str | None = None,
                     progress=None, device="cuda",
                     timer: StageTimer | None = None, dist=None,
                     mesh_devices=None):
    """The `ancient_assemble` (guidedNuclAssemble) workflow: nuclassemble
    with the guided parameter overrides, linclust redundancy reduction,
    representative extraction, headers and FASTA output
    (data/guidedNuclAssemble.sh:177-225, src/workflow/GuidedNuclassembler.cpp).

    Returns the final SeqDB of representative contigs (key order), with
    headers '<rank> len:<len>[ cycle:<0|1>]'.  `device`, `timer`,
    `dist` and `mesh_devices` as in nuclassemble; linclust and the FASTA
    output run on the host, on rank 0 alone under `dist` (the other ranks
    return None).
    """
    from .stages.linclust import linclust

    log = progress or (lambda *_: None)
    # guided overrides of the inner nuclassemble defaults
    # (GuidedNuclassembler.cpp:12-31,170-180: numIterations 10 via
    # multiNumIterations.nucleotides, reads-only count stays at the CLI
    # default 5, maxSeqLen 200000)
    p = params.copy_defaults(num_iterations=10, num_iterations_reads=5,
                             max_seq_len=200000)
    assembly, cycle_keys, _ = nuclassemble(
        reads, p, damage,
        tmp_dir=os.path.join(tmp_dir, "nuclassembly_tmp") if tmp_dir else None,
        progress=progress, device=device, timer=timer, dist=dist,
        mesh_devices=mesh_devices)
    if dist is not None and dist.rank != 0:
        # the epilogue (linclust + FASTA) is rank 0's, as only the
        # reference's master writes merged results
        return None
    log(f"nuclassemble: {len(assembly)} contigs, {len(cycle_keys)} circular")

    # redundancy reduction
    with (timer or StageTimer()).time("linclust"):
        clusters = linclust(assembly, p.clust_seq_id_thr, p.clust_cov_thr,
                            p.clust_cov_mode)
    rep_keys = sorted(clusters.keys())
    key2id = assembly.key_to_id()
    rep = assembly.select(np.array([key2id[k] for k in rep_keys],
                                   dtype=np.int64))
    log(f"linclust: {len(rep)} representative contigs")

    # headers: '<rank-in-key-order> len:<len>' + cycle flag when circular
    # contigs exist (createhdb.cpp:47-68)
    has_cycles = any(k in cycle_keys for k in rep_keys)
    headers = []
    for idx, k in enumerate(rep_keys):
        h = f"{idx} len:{int(rep.lengths[idx])}"
        if has_cycles:
            h += f" cycle:{1 if k in cycle_keys else 0}"
        headers.append(h)
    rep.headers = headers
    if out_fasta:
        rep.to_fasta(out_fasta)
    return rep
