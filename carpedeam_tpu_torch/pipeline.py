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
runs the host oracles instead, as the JAX package does
(`_pick_stage_impls`).
"""
from __future__ import annotations

import os
import time
from functools import partial

import numpy as np

from .damage import DamageModel
from .io.seqdb import SeqDB
from .kmer.matcher import kmermatcher
from .ops.correction_cuda import correction_cuda
from .ops.correction_device import correction_device_stage
from .ops.kmer_device import kmermatcher_device
from .ops.rescore_cuda import rescorediagonal_cuda
from .ops.rescore_device import rescorediagonal_device
from .params import ParamError, Params, parse_byte_size
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


def _pick_stage_impls(use_device: str, device):
    """(rescore_fn, correction_fn, device or None, planes_out) for
    `--use-device`, the counterpart of carpedeam_tpu/pipeline.py::
    _pick_stage_impls.

    "0" runs the host oracles (native C++): no planes, no card, so it
    runs on a machine without one.  "auto" and "pallas" run the CUDA
    kernels on `device` (their plain PyTorch versions when `device` is
    the CPU); their correction can derive the corrected planes on the
    device (`planes_out`).  "1" runs the JAX package's tensor programs
    for accelerators that are not TPUs (ops/rescore_device.py,
    ops/correction_device.py) on `device`.  "mesh" (the sharded stages)
    has no implementation in the port yet and raises rather than run
    another one in its place."""
    if use_device == "0":
        return rescorediagonal, correction, None, False
    if use_device == "mesh":
        raise ParamError("--use-device mesh (the sharded stages of "
                         "parallel/mesh.py) has no implementation in the "
                         "PyTorch port yet (ROADMAP Queue 1 item 5); use 0, "
                         "1, auto or pallas")
    dev = resolve_device(device)
    if use_device == "1":
        return (partial(rescorediagonal_device, device=dev),
                partial(correction_device_stage, device=dev), dev, False)
    return (partial(rescorediagonal_cuda, device=dev),
            partial(correction_cuda, device=dev), dev, True)


def nuclassemble(reads: SeqDB, params: Params, damage: DamageModel,
                 tmp_dir: str | None = None, progress=None, device="cuda",
                 timer: StageTimer | None = None):
    """The inner assembly loop (data/nuclassemble.sh:97-233).

    Returns (result SeqDB, cycle_all keys set, source SeqDB).  `device`
    is "cuda" (default; raises without a card) or "cpu", and is not read
    under `params.use_device == "0"` (the host oracles); `timer`
    (optional) collects the per-stage wall times.
    """
    rescore_fn, correction_fn, dev, planes_out = _pick_stage_impls(
        params.use_device, device)
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
        `_shared_from` below collects the finished planes.  The host
        oracles take no planes."""
        if dev is None or not len(db):
            return None
        from .ops.planes import PlanesPrefetch
        # plane width is capped at 512: the short-read bulk stays device-
        # resident in every phase; stages route records touching longer
        # sequences to wider per-bucket planes or the host oracles
        max_len = bucket_len(min(512, int(db.lengths.max())))
        return PlanesPrefetch(db, max_len=max_len, device=dev)

    def _shared_from(pf):
        if pf is None:
            return {}
        planes, lengths = pf.get()
        return {"planes": planes, "lengths": lengths}

    def _shared_planes(db):
        """Pack + upload the sequence planes once; the device stages then
        reuse the same device-resident tensors."""
        return _shared_from(_planes_prefetch(db))
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
        with timer.time(f"kmermatcher_{step}"):
            pref = kmermatcher_fn(
                cur,
                params.kmer_size_reads if read_phase
                else params.kmer_size_contigs,
                params.kmers_per_sequence,
                params.kmers_per_sequence_scale,
                params.include_only_extendable_reads if read_phase
                else params.include_only_extendable_contigs,
                params.hash_shift)
        shared = _shared_from(planes_pf)
        seq_id = params.seq_id_thr if read_phase \
            else params.corr_contig_seq_id
        with timer.time(f"rescorediagonal_{step}"):
            aln = rescore_fn(cur, pref, seq_id, params.eval_thr,
                             params.aln_len_thr, **shared)
        if read_phase:
            ext_pro = None
            corr_shared = None
            with timer.time(f"correction_{step}"):
                if shared and planes_out:
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
                    if corr_shared is not None \
                            and not params.ancient_unsafe:
                        from .ops.extension_batch import ext_prologue
                        ext_pro = ext_prologue(cur, aln,
                                               corr_shared["planes"],
                                               corr_shared["lengths"])
                    corr = corr_fin()
                else:
                    corr = correction_fn(cur, aln, damage,
                                         params.corr_reads_ry_seq_id,
                                         params.seq_id_thr, **shared)
            with timer.time(f"read_assembly_{step}"):
                # extension scores run over the CORRECTED sequences: the
                # device-derived corrected planes serve when available,
                # else pack fresh ones
                nxt = read_assembly(corr, aln, damage, params.seq_id_thr,
                                    params.ry_seq_id_thr,
                                    params.likelihood_threshold,
                                    params.random_align_penal,
                                    params.excess_penal,
                                    params.max_seq_len,
                                    params.ancient_unsafe,
                                    params.min_cov_safe,
                                    prologue=ext_pro,
                                    **(corr_shared if corr_shared
                                       is not None
                                       else _shared_planes(corr)))
        else:
            with timer.time(f"correction_{step}"):
                corr = correction_fn(cur, aln, damage,
                                     params.corr_reads_ry_seq_id,
                                     params.corr_contig_seq_id, **shared)
            with timer.time(f"contig_merge_{step}"):
                nxt = contig_merge(corr, aln, damage,
                                   params.merge_seq_id_thr,
                                   params.ry_seq_id_thr,
                                   params.max_seq_len,
                                   params.ancient_unsafe,
                                   params.min_cov_safe)

        if ck.tmp:
            nxt.save(ck.path(name), compressed=bool(params.compressed))
            ck.mark(name)
        log(f"step {step}: {'reads' if read_phase else 'contigs'} "
            f"n={len(nxt)} extended={int(nxt.ext.sum())}")
        cur = nxt

        if not read_phase and params.cycle_check:
            cyc, none_cyc = cyclecheck(cur, k=22, chop=params.chop_cycle,
                                       max_seq_len=params.max_seq_len)
            if ck.tmp:
                cyc.save(ck.path(f"cycle_{step}"),
                         compressed=bool(params.compressed))
                ck.mark(f"cycle_{step}")
            if len(cyc):
                for j in range(len(cyc)):
                    cycle_all[int(cyc.keys[j])] = bytes(cyc.seq_bytes(j))
                    cycle_ext[int(cyc.keys[j])] = bool(cyc.ext[j])
                log(f"step {step}: {len(cyc)} circular contigs set aside")
                cur = none_cyc
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
                     timer: StageTimer | None = None):
    """The `ancient_assemble` (guidedNuclAssemble) workflow: nuclassemble
    with the guided parameter overrides, linclust redundancy reduction,
    representative extraction, headers and FASTA output
    (data/guidedNuclAssemble.sh:177-225, src/workflow/GuidedNuclassembler.cpp).

    Returns the final SeqDB of representative contigs (key order), with
    headers '<rank> len:<len>[ cycle:<0|1>]'.  `device` and `timer` as
    in nuclassemble; linclust and the FASTA output run on the host.
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
        progress=progress, device=device, timer=timer)
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
